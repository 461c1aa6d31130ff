"""paddle_tpu_torch.distributed: checkpoints. The rest of the JAX
package's distributed layer (master, pserver, meshes, collectives) waits
for later slices (ROADMAP A9-A11)."""
from .checkpoint import (latest_checkpoint, load_checkpoint,  # noqa: F401
                         save_checkpoint)

__all__ = ["save_checkpoint", "latest_checkpoint", "load_checkpoint"]
