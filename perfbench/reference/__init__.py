"""The plain reference of quantised DiT serving (imports nothing of the program)."""
