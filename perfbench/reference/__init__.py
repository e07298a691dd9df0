"""The plain reference: the paper's planner and search, imports nothing of
the program."""
