"""Distribution over the ranks of a ``torch.distributed`` process group, port
of ``kajo_tpu/parallel/``: lane-sharded passes (``render.py``), the
object-sharded wavefront (``objshard.py``) and multi-process rendering
(``multihost.py``)."""
