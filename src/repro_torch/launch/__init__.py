"""Step builders and launchers of the port (``repro/launch``)."""
