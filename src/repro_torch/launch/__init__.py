"""Launch helpers: the serving steps of the LM path (port of
``repro.launch.serve``) and the clients mesh of the client-parallel round
(``launch/mesh.py``)."""
