"""Serving steps of the LM path (port of ``repro.launch.serve``)."""
