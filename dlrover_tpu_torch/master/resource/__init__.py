"""Resource plans and the optimizer that produces them."""
