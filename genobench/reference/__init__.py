"""The plain reference that decides ``correct``: numpy and Python only,
importing nothing of the program under test."""
