"""The dry run's cost counter: what one rank's step does, op by op.

The counterpart of the reference's ``utils/hlo_cost.loop_aware_cost`` and
``utils/hlo_stats.collective_stats``, which read a compiled XLA module.
The port runs eagerly, so ``OpCost`` is a ``TorchDispatchMode`` that sees
every aten op of the step as it runs (on meta tensors in the dry run,
``launch.dryrun``: shapes only, nothing allocated) and counts:

* ``flops``: the products' FLOPs by ``torch.utils.flop_counter``'s formulas
  (2·M·N·K for a matmul; convolutions, batched products and attention
  alike), plus each hand-written kernel's count. Elementwise ops add none,
  as in ``hlo_cost``, which counts dots and convolutions;
* ``bytes``: each op's tensor operands plus its results, the eager
  counterpart of ``hlo_cost``'s operand-plus-result bytes of its
  post-fusion ops (eager runs no fusion, so this is an upper bound of
  what a fused step moves); view ops and allocations move nothing; plus
  each kernel's bytes by its bound's formula (``kernels.cost``);
* ``peak_bytes``: the most bytes live at once in storages that the step
  made (its arguments, registered with ``arguments``, not included), each
  storage counted once and released when it is freed: the counterpart of
  ``temp_size_in_bytes``;
* ``kernels``: per hand-written kernel, its calls and their FLOPs and
  bytes, added by each wrapper's meta route (``record_kernel``);
* ``collectives``: per kind ("all-reduce", "all-gather",
  "reduce-scatter"), its count and result bytes, added by the
  collectives' meta transport (``record_collective``), as
  ``collective_stats`` counts result bytes.

Eager runs every layer, so no trip-count correction is needed: a 61-layer
stack runs 61 layers' ops (the reference's scan visits its body once and
``hlo_cost`` multiplies it by the loop's trip count).
"""
from __future__ import annotations

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_active: list = []  # the OpCost modes entered, innermost last

# ops that allocate or alias and move no data
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "alias", "_unsafe_view"}


def active():
    """The innermost ``OpCost`` in use, or None."""
    return _active[-1] if _active else None


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """Add one call of kernel ``name`` to the active counter (none: no-op)."""
    c = active()
    if c is not None:
        row = c.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        row["calls"] += 1
        row["flops"] += int(flops)
        row["bytes"] += int(nbytes)


def record_collective(kind: str, nbytes: int) -> None:
    """Add one collective of ``kind`` whose result holds ``nbytes``."""
    c = active()
    if c is not None:
        row = c.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += int(nbytes)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts one span's ops (module docstring); ``summary()`` reads them."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict = {}
        self.collectives: dict = {}
        self.peak_bytes = 0
        self._live = 0
        self._storages: dict = {}  # id of a storage the span made -> (weak ref, bytes)
        self.args: dict = {}  # id of an argument's storage -> its bytes

    def arguments(self, *trees) -> int:
        """Register the step's inputs (tensors anywhere in ``trees``, a
        module's parameters and buffers): their storages are not the step's
        own. Returns their bytes, each storage once."""
        total = 0
        leaves = [list(x.parameters()) + list(x.buffers()) if isinstance(x, torch.nn.Module)
                  else x for x in tree_flatten(trees)[0]]
        for t in tree_flatten(leaves)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.args:
                    self.args[st._cdata] = st.nbytes()
                    total += st.nbytes()
        return total

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._storages.items() if ref.expired()]:
            self._live -= self._storages.pop(key)[1]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args:
            return
        known = self._storages.get(key)
        if known is not None:
            if not known[0].expired():
                return
            self._live -= known[1]  # a freed storage's address, reused
        self._storages[key] = (StorageWeakRef(st), st.nbytes())
        self._live += st.nbytes()
        if self._live > self.peak_bytes:  # an upper bound: sweep the freed ones
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(tensor_bytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def summary(self) -> dict:
        """The span's counts: total FLOPs and bytes (aten ops and kernels),
        collectives by kind, peak bytes, and the per-kernel records."""
        k_flops = sum(r["flops"] for r in self.kernels.values())
        k_bytes = sum(r["bytes"] for r in self.kernels.values())
        return {"flops": float(self.flops + k_flops),
                "bytes_accessed": float(self.bytes + k_bytes),
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "collective_bytes": float(sum(v["bytes"] for v in self.collectives.values())),
                "peak_bytes": self.peak_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}
