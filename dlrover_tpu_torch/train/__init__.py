"""Training of the port: optimizer and the single-device ElasticTrainer."""
