"""Where a model call runs on a mesh: ``MeshCtx``, the port of the JAX
package's ``models/moe.py:44``, field for field.

The JAX file also holds the Mixture-of-Experts layers; they are not ported
yet (ROADMAP queue 1, item 6) and will join ``MeshCtx`` here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.mesh import AbstractMesh


@dataclass(frozen=True)
class MeshCtx:
    """Where a model call runs: the rank's mesh (a ``core.mesh.ProcessMesh``,
    or an ``AbstractMesh`` where only the layout is computed) and the role
    of each axis."""
    mesh: AbstractMesh
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)   # axes params are sharded over
    moe_a2a_ep: bool = False                 # token-routing EP (§Perf H6)
    engine_replicate: bool = False           # SSM/mLSTM engine batch-shard only
    seq_parallel: bool = False               # S-sharded residual (§Perf H5)
    foopar_tp: bool = False                  # algebra (DSeq) TP matmuls in MLP
    manual_attention: bool = False           # manual SDPA region (§Perf A8)
    dp_over_model: bool = False              # pure DP over both axes (§Perf C7)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    @property
    def model_size(self) -> int:
        return self.mesh.size(self.model_axis)
