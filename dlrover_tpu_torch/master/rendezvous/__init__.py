"""Master-side rendezvous, KV store and named barriers."""
