"""Sharding rules: logical axes → mesh axes with divisibility fallback."""
from .rules import (ACT_RULES, WEIGHT_RULES, MeshAxes, as_mesh, batch_axes,
                    mesh_ctx, placements, set_mesh_ctx, shard_act, spec_for,
                    state_axes, tree_shardings)

__all__ = ["ACT_RULES", "WEIGHT_RULES", "MeshAxes", "as_mesh", "batch_axes",
           "mesh_ctx", "placements", "set_mesh_ctx", "shard_act",
           "spec_for", "state_axes", "tree_shardings"]
