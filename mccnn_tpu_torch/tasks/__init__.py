"""Command-line tasks of the port."""
