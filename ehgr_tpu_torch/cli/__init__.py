"""Command-line verbs of the port (counterparts of ``cli/``)."""
