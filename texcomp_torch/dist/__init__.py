"""Device meshes and the batched asset pipeline.

One process drives every device of a mesh (``mesh.Mesh``):

  * within a device: a batch of same-shape textures is one kernel launch
    (the tall fold of ``pipeline._batch_encode``);
  * across devices: a batch splits over the mesh's "data" devices (and
    one image's blocks over its "block" devices), with quality sums the
    only thing combined, on the host;
  * across processes: ``multihost`` splits the asset list round-robin,
    with ``torch.distributed`` (gloo) as the control plane only.
"""

from texcomp_torch.dist.mesh import (
    dxt1_pipeline_sharded,
    make_mesh,
    training_step_multichip,
)

__all__ = ["dxt1_pipeline_sharded", "make_mesh", "training_step_multichip"]
