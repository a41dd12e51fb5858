"""The master's data sharding: splitters, dataset managers, the task manager."""
