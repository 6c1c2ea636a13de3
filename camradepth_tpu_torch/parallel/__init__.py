"""Multi-device training under ``torch.distributed``: the process group
(``multihost.py``), the training layout and its wrappers (``mesh.py``), and
the gradient check of a layout against the unsharded step
(``gradcheck.py``)."""
