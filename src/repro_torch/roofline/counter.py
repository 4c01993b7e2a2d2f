"""One device's FLOPs, bytes, collectives and memory for a step run on fake
tensors: the dry run's analogue of XLA's ``cost_analysis`` and
``memory_analysis`` of one device's compiled program.

:class:`StepCounter` is a ``FakeTensorMode``: tensors made under it have
shapes and no storage. DTensor runs each operation on a device's local
shards (fake tensors of this mode), so every operation that reaches this
mode's dispatch is one device's own; the DTensor-level call above it
(global shapes) is not counted. For each operation at the top level (the
decompositions that the fake mode runs inside an operation are not
counted again):

* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention), on the local shapes; element-wise operations
  count nothing, as in ``FlopCounterMode``;
* ``hbm_bytes``: the bytes the operation reads and writes, once each, as an
  eager PyTorch program moves them: every tensor argument and every output,
  except views (no traffic) and allocations; a gather (``embedding``,
  ``index_select``, ``gather``, ``index``) reads only the rows it returns;
* ``collectives``: the result bytes of each collective (the reference's
  measure), by the reference's kinds;
* ``peak_bytes``: the most bytes that the step's own allocations held at
  once (the storages it made, freed when their last tensor dies), and
  ``argument_bytes``, the local shards the step was given (set by the
  caller). ``MemTracker`` (``torch.distributed._tools``) cannot give these:
  it is a dispatch mode above DTensor and sees global shapes.

The hand-written kernels cannot run on fake tensors. While a counter is
active the kernel wrappers charge their kernel's own FLOPs and bytes
(:meth:`StepCounter.charge`, through ``kernels.counting``) and return
outputs of the right shape without launching anything.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.roofline.analysis import COLLECTIVES

#: operations that read only the rows they return
_GATHERS = ("aten.embedding", "aten.index_select", "aten.gather",
            "aten.index")
#: operations that allocate and move nothing
_ALLOCS = ("aten.empty", "aten.empty_strided", "aten.empty_like",
           "aten.new_empty", "aten.new_empty_strided")


_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def _collective(name: str):
    """The reference's kind of a collective operation, or None."""
    for key, kind in (("all_gather", "all-gather"), ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                      ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("permute", "collective-permute"),
                      ("send", "collective-permute")):
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                out.extend(_tensors(x))
        return out
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


_COMPOSITE: Dict = {}


def _composite(func) -> bool:
    """True for an operation with no kernel of its own (a
    CompositeImplicitAutograd decomposition)."""
    got = _COMPOSITE.get(func)
    if got is None:
        try:
            got = torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
        except RuntimeError:      # not a dispatcher operation (prim::)
            got = False
        _COMPOSITE[func] = got
    return got


#: each operation's role in the count, its name (or collective kind) and
#: its FLOP formula, by operation
_INFO: Dict = {}


def _op_info(func):
    from torch.utils.flop_counter import flop_registry

    name = func._overloadpacket._qualified_op_name.replace("::", ".")
    if name.startswith(_COLLECTIVE_NAMESPACES):
        kind = _collective(name)      # None: a wait, no payload
        return ("wait", name, None) if kind is None else (
            "collective", kind, None)
    if func.is_view:
        return "view", name, None
    if name.startswith(_ALLOCS):
        return "alloc", name, None
    role = ("gather" if name in _GATHERS else
            "mutating" if func._schema.is_mutable else "compute")
    return role, name, flop_registry.get(func._overloadpacket)


class StepCounter(FakeTensorMode):
    """Counts one device's work while it is the fake mode (see the module's
    docstring). ``with StepCounter() as c:`` then make the inputs, call
    :meth:`start`, run the step; read ``flops``, ``hbm_bytes``,
    ``collectives``, ``peak_bytes``."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.flops_by_op: Dict[str, float] = collections.Counter()
        self.charged: Dict[str, int] = collections.Counter()
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracking = False
        self._depth = 0
        self._muted = 0
        self._seen = weakref.WeakSet()

    # -- the step's window -------------------------------------------------
    def start(self, argument_bytes: int = 0) -> None:
        """Zero the counts and start tracking allocations (call after the
        inputs are made)."""
        self.flops = self.hbm_bytes = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.flops_by_op = collections.Counter()
        self.charged = collections.Counter()
        self.argument_bytes = int(argument_bytes)
        self.live_bytes = self.peak_bytes = 0
        self._tracking = True

    def stop(self) -> None:
        self._tracking = False

    # -- what the kernel wrappers call --------------------------------------
    def charge(self, kernel: str, flops: float, nbytes: float) -> None:
        """A hand-written kernel's own work (its launch is not counted by
        any operation)."""
        self.flops += flops
        self.hbm_bytes += nbytes
        self.flops_by_op[kernel] += flops
        self.charged[kernel] += 1

    def track(self, *outs) -> None:
        """Count the storages of ``outs`` as allocations of the step."""
        for t in _tensors(outs):
            self._alloc(t)

    # -- the dispatch ---------------------------------------------------------
    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth:
            return super().dispatch(func, types, args, kwargs)
        if _composite(func):
            # an operation that only calls others (``matmul`` and ``einsum``
            # reach here whole under inference mode): the operations it
            # calls are the ones counted, so it is decomposed here, past
            # the fake mode's cache of whole results
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            return super().dispatch(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is not NotImplemented and self._tracking and not self._muted:
            self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        role, name, flop_fn = info
        if role == "view":
            return
        outs = _tensors(out)
        if role == "collective":
            self.collectives[name] += sum(_nbytes(t) for t in outs)
            return
        if role == "wait" or not outs:
            return
        if role == "alloc":
            for t in outs:
                self._alloc(t)
            return
        if flop_fn is not None:
            f = float(flop_fn(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] += f
        ins = _tensors(args) + (_tensors(kwargs) if kwargs else [])
        if role == "gather":
            moved = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins if not t.is_floating_point())
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        self.hbm_bytes += moved
        if role != "mutating":
            for t in outs:
                self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n
