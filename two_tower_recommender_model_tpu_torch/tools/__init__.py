"""Measurement tools of the port, run as modules (`python -m ...tools.<name>`)."""
