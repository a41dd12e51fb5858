"""The brain's decision engines (the goodput planner)."""
