"""Process-group parallelism (counterpart of ``pano360_tpu.parallel``):
``mesh`` holds the mesh, its collectives, the rank launcher and the JAX
module's building blocks; ``dryrun`` runs the production pipeline over
n ranks against one process."""
from pano360_tpu_torch.parallel.mesh import (Mesh, distributed_lm_stats,
                                             distributed_step, launch,
                                             make_mesh,
                                             sharded_color_extract,
                                             sharded_extract,
                                             sharded_match_all_pairs,
                                             sharded_pair_match)

__all__ = ["Mesh", "make_mesh", "launch", "sharded_extract",
           "sharded_pair_match", "distributed_lm_stats", "distributed_step",
           "sharded_color_extract", "sharded_match_all_pairs"]
