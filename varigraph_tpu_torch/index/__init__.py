"""Graph data model and .vgt loading."""
