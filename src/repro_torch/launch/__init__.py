"""Launch helpers: the serving steps of the LM path (port of
``repro.launch.serve``), the dense LM train step (``launch/train.py``, port
of ``repro.launch.train``'s ``loss_fn`` and ``make_dense_train_step``), one
participant's parameters sharded over its ``data`` and ``model`` positions
(``launch/fsdp.py``), its tensor-parallel step over its ``model`` positions
(``launch/tp.py``) and the clients mesh of the client-parallel round
(``launch/mesh.py``)."""
