"""The plain float32 reference of the served models (no program imports)."""
