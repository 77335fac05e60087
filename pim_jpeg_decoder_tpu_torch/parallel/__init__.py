"""Several devices in one process, several processes over gloo.

Counterpart of ``pim_jpeg_decoder_tpu/parallel/``: a device list with MCU
tiles as the sharded axis (``mesh.py``), the per-shard decode on each
device (``sharding.py``), and whole-image sharding across processes with
only metadata crossing between them (``multihost.py``).
"""

from pim_jpeg_decoder_tpu_torch.parallel.mesh import MCU_AXIS, make_mesh
from pim_jpeg_decoder_tpu_torch.parallel.sharding import decode_mcus_sharded

__all__ = ["make_mesh", "MCU_AXIS", "decode_mcus_sharded"]
