"""The plain references the check compares the program with."""
