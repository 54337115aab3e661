"""Plain references, one per configuration family; they import nothing of
the program."""
