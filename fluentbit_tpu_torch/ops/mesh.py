"""Device meshes for the sharded programs: grep (K5), the sketches (K8)
and the flux plane (K9's and K10's mesh halves).

The port's counterpart of ``fluentbit_tpu/ops/mesh.py``, trimmed to what
those programs need. A ``Mesh`` is a tuple of ``torch.device``s with one
axis name. A program sharded over it cuts one axis of its batch into one
slice per entry, sends each slice (and the table leaves the partition
rules shard) to that entry's device, and launches its kernel there. The
sketch and flux programs then merge the shards' partial states on the
first entry's device (``ops.sketch.shard_merge``: the reference's
``pmax`` / ``psum``).

``build_mesh`` takes the visible CUDA devices and returns None below
two, as the reference does below two devices. A mesh built by hand may
repeat a device: ``Mesh((torch.device("cuda", 0),) * 8)`` runs the
per-shard launches, the padding to the shard count and the per-shard
tables of an 8-device mesh on one card, and ``Mesh((cpu,) * 8)`` does
the same with the plain versions. Copies between cards, cross-card
concurrency and NCCL need a second card.

The reference's donation helpers (``aliasable_donations``,
``donation_report``) have no counterpart: torch has no buffer donation.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AXIS", "Mesh", "MeshLaunches", "PARTITION_RULES", "build_mesh",
           "mesh_info", "mesh_key", "pad_to_devices", "partition_rules",
           "replicated_table_bytes", "shard_leaf"]


class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, repeats
    allowed) along one axis named ``axis_names[0]``."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices: Iterable, axis: str = "batch"):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names: Tuple[str, ...] = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


class MeshLaunches:
    """A sharded program's launch count: one per shard whose kernel ran
    on a CUDA device (the kernels count their own launches too). A plain
    integer a caller may reset; shards on the CPU take the plain
    versions and count nothing."""

    def __init__(self) -> None:
        self.launches = 0


#: Placeholder bound to the mesh's axis name by ``partition_rules``.
AXIS = "@axis"

#: The layout of each sharded program's table leaves: ``(regex over the
#: leaf name, spec)``, a spec naming per dimension the axis it shards
#: along or None; an empty spec replicates the leaf.
PARTITION_RULES: Dict[str, Tuple[Tuple[str, Tuple[Any, ...]], ...]] = {
    # batch variant: B shards across devices, every table leaf replicates
    "grep-batch": (
        (r"^(trans_flat|class_maps|pair_maps|C|Ck|eol_cls|starts|n_states"
         r"|tab16|kp)$", ()),
    ),
    # rule-sharded variant: each device holds 1/n of the rules, the 2-D
    # leaves and the per-rule vectors split on the rule axis
    "grep-rules": (
        (r"^(trans_flat|class_maps|pair_maps|tab16)$", (AXIS, None)),
        (r"^(C|Ck|eol_cls|starts|n_states|kp)$", (AXIS,)),
    ),
    # sketch state replicates: every shard absorbs its rows into a zeroed
    # partial, merged by max (HLL) / sum (count-min) on the first device
    "flux-hll": ((r"^registers$", ()),),
    "flux-cms": ((r"^table$", ()),),
    # group counts: the batch columns shard, the counts merge by sum
    "flux-counts": ((r"^(seg|valid)$", (AXIS,)),),
    # the fused absorb: every batch-axis column shards (the composites
    # along their own row axis), the register stacks and the table
    # replicate
    "flux-fused": (
        (r"^(seg|valid|lengths|comp_len)$", (AXIS,)),
        (r"^(batch|comp)$", (AXIS, None)),
        (r"^(registers|table)$", ()),
    ),
}


def partition_rules(key: str, axis: str) -> Tuple[Tuple[str, tuple], ...]:
    """The ``(regex, spec)`` rows of one table of ``PARTITION_RULES``
    with the axis placeholder bound to ``axis``. An unknown key raises."""
    try:
        rows = PARTITION_RULES[key]
    except KeyError:
        raise KeyError(f"unknown partition-rule table {key!r}; known: "
                       f"{sorted(PARTITION_RULES)}") from None
    return tuple((regex, tuple(axis if t == AXIS else t for t in tmpl))
                 for regex, tmpl in rows)


def _spec_for(rules: Sequence[Tuple[str, tuple]], name: str) -> tuple:
    for regex, spec in rules:
        if re.search(regex, name) is not None:
            return spec
    raise ValueError(f"no partition rule matches leaf {name!r}")


def shard_leaf(rules: Sequence[Tuple[str, tuple]], name: str,
               leaf: torch.Tensor, axis: str, n: int,
               i: int) -> torch.Tensor:
    """Shard ``i`` of ``n`` of the table leaf ``name`` under ``rules``:
    the leaf itself where its spec replicates it, else its i-th equal
    slice along the sharded dimension (which ``n`` must divide)."""
    spec = _spec_for(rules, name)
    for dim, s in enumerate(spec):
        if s != axis:
            continue
        size = leaf.shape[dim]
        if size % n:
            raise ValueError(f"leaf {name!r} dim {dim} ({size}) does not "
                             f"split into {n} shards")
        step = size // n
        leaf = leaf.narrow(dim, i * step, step)
    return leaf


def build_mesh(n_devices: Optional[int] = None,
               axis: str = "batch") -> Optional[Mesh]:
    """A mesh over the visible CUDA devices (the first ``n_devices``);
    None when fewer than two exist (sharding would be pure overhead)."""
    if not torch.cuda.is_available():
        return None
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    if len(devs) < 2:
        return None
    return Mesh(devs, axis)


def mesh_key(mesh: Mesh) -> tuple:
    """Structural cache key: equal meshes share their per-shard tables."""
    return (tuple(mesh.axis_names), tuple(str(d) for d in mesh.devices))


def mesh_info(mesh: Optional[Mesh]) -> Dict[str, Any]:
    """Shape, platform and whether the mesh repeats a device (a stand-in
    for a larger mesh on fewer cards)."""
    if mesh is None:
        return {"devices": 1, "axis_names": [], "simulated": False,
                "platform": None}
    return {
        "devices": mesh.size,
        "axis_names": list(mesh.axis_names),
        "platform": mesh.devices[0].type,
        "simulated": len(set(mesh.devices)) < mesh.size,
    }


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest multiple of the device count >= n."""
    if n_devices <= 1:
        return n
    return ((n + n_devices - 1) // n_devices) * n_devices


def replicated_table_bytes(tables) -> int:
    """Bytes of a program's table leaves (numpy arrays or tensors; None
    leaves skipped): what the batch variant copies to every device, and
    what ``mesh_variant`` weighs against ``FBTPU_MESH_TABLE_BUDGET``."""
    total = 0
    for v in (tables.values() if isinstance(tables, dict) else tables):
        if v is None or getattr(v, "shape", None) is None:
            continue
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            total += int(np.prod(v.shape)) * int(v.dtype.itemsize)
    return total
