"""What one call dispatches, counted per rank: the counterpart of the
reference's ``repro.roofline.hlo_cost.HloCostModel``, which parses XLA's
partitioned program.  Eager PyTorch has no such program, so
:class:`Counter` is a ``TorchDispatchMode`` that watches the call run:

1. **dot flops**: 2·M·N·K per matrix product (``mm``, ``bmm``,
   ``addmm``, convolutions; the formulas of
   ``torch.utils.flop_counter.flop_registry``);
2. **flops**: the dot flops plus one flop per floating output element of
   every other computing op (the reference's elementwise count); data
   movement and new buffers (copies, type casts, concatenation, gathers,
   padding, ``where``) count none, as XLA's convert/copy/gather do not;
3. **bytes**: each op's operands read plus its results written.  In eager
   PyTorch every aten op is a kernel that reads and writes device memory,
   so this is the eager program's traffic, the counterpart of the
   reference's "fusion interfaces" (views, ``_unsafe_view`` included,
   and bare allocations launch no kernel and count none);
4. **collectives**: the operand bytes and the count of each
   ``_c10d_functional`` collective (what ``DTensor`` redistributions and
   ``local_map`` issue) and of each ``c10d`` op that ``dist.all_reduce``,
   ``all_gather``, ``all_to_all_single`` and ``send`` dispatch, under the
   reference's five kinds (a ``send`` is one hop of a
   ``collective-permute``; ``recv`` and ``wait_tensor`` count nothing:
   their bytes are the matching send's).

**Per rank on DTensors.**  An op on ``DTensor`` arguments is handed back
to ``DTensor`` unrun (the mode returns ``NotImplemented``), which
propagates the sharding, issues any redistribution, and runs the op on
one rank's local shards, with this mode still active: so the mode counts
the local products at the local shapes the sharding propagator chose
(a ``Partial`` output is a product whose contracted dim is split) and the
collectives with their local operands.  The ``DTensor``-level op with its
global shapes is not counted, nor is the op ``DTensor``'s sharding
propagator runs on fake tensors of the global shapes to infer an output's
shape (once per new op and layout); ``FlopCounterMode`` counts that global
op beside the local one and reports their sum.  On plain tensors every
op is local and counted once.
All figures are one rank's (rank 0 of a fake group, which holds the
largest shard of an uneven split); callers multiply by the rank count for
a module total, as the reference's callers do.
"""
from __future__ import annotations

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def _collectives():
    """{op packet: (kind, index of the operand argument)}."""
    ops = {}
    funcol = torch.ops._c10d_functional
    for name, kind in (("all_reduce", "all-reduce"),
                       ("all_reduce_", "all-reduce"),
                       ("all_reduce_coalesced", "all-reduce"),
                       ("all_gather_into_tensor", "all-gather"),
                       ("all_gather_into_tensor_coalesced", "all-gather"),
                       ("reduce_scatter_tensor", "reduce-scatter"),
                       ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                       ("all_to_all_single", "all-to-all")):
        if hasattr(funcol, name):
            ops[getattr(funcol, name)] = (kind, 0)
    autograd = getattr(torch.ops, "_c10d_functional_autograd", None)
    if autograd is not None and hasattr(autograd, "all_to_all_single"):
        ops[autograd.all_to_all_single] = ("all-to-all", 0)
    c10d = torch.ops.c10d
    for name, kind, arg in (("allreduce_", "all-reduce", 0),
                            ("allreduce_coalesced_", "all-reduce", 0),
                            ("allgather_", "all-gather", 1),
                            ("_allgather_base_", "all-gather", 1),
                            ("allgather_into_tensor_coalesced_",
                             "all-gather", 1),
                            ("reduce_scatter_", "reduce-scatter", 1),
                            ("_reduce_scatter_base_", "reduce-scatter", 1),
                            ("reduce_scatter_tensor_coalesced_",
                             "reduce-scatter", 1),
                            ("alltoall_", "all-to-all", 1),
                            ("alltoall_base_", "all-to-all", 1),
                            ("send", "collective-permute", 0)):
        if hasattr(c10d, name):
            ops[getattr(c10d, name)] = (kind, arg)
    return ops


def _silent():
    """Comm ops that move no bytes of their own (the matching send or
    collective counted them)."""
    out = set()
    for ns, name in (("_c10d_functional", "wait_tensor"),
                     ("_c10d_functional", "_wrap_tensor_autograd"),
                     ("c10d", "recv_"), ("c10d", "recv_any_source_"),
                     ("c10d", "barrier"), ("c10d", "monitored_barrier_")):
        space = getattr(torch.ops, ns, None)
        if space is not None and hasattr(space, name):
            out.add(getattr(space, name))
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class Counter(TorchDispatchMode):
    """Counts what runs while it is entered (``with Counter() as c:``):
    ``c.flops``, ``c.dot_flops``, ``c.bytes``, ``c.coll_bytes`` and
    ``c.coll_counts`` (each a dict by kind), one rank's figures."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        aten = torch.ops.aten
        self._fake = FakeTensor
        self._products = flop_registry
        # data movement and new buffers: bytes, no flops
        self._moves = {aten._to_copy, aten.copy_, aten.clone, aten.cat,
                       aten.stack, aten.gather, aten.index_select,
                       aten.index, aten.repeat, aten.fill_, aten.zero_,
                       aten.lift_fresh, aten.constant_pad_nd, aten.where}
        # ops that launch no kernel: views the schema does not mark as
        # such, and allocations that write nothing
        self._aliases = {aten._unsafe_view, aten.alias, aten.empty,
                         aten.empty_strided, aten.empty_like,
                         aten.new_empty, aten.new_empty_strided}
        self._coll = _collectives()
        self._silent = _silent()
        self.flops = 0
        self.dot_flops = 0
        self.bytes = 0
        self.coll_bytes = {k: 0 for k in COLL_KINDS}
        self.coll_counts = {k: 0 for k in COLL_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # DTensor's module is loaded once a DTensor exists
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor and any(issubclass(t, dtensor.DTensor) for t in types):
            return NotImplemented      # count the local ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types) or any(
                isinstance(t, self._fake) for t in tree_flatten(out)[0]):
            return out                 # DTensor's global shape inference
        if (not isinstance(func, torch._ops.OpOverload) or func.is_view
                or func.overloadpacket in self._aliases):
            return out
        packet = func.overloadpacket
        if packet in self._coll:
            kind, arg = self._coll[packet]
            self.coll_bytes[kind] += _nbytes(args[arg])
            self.coll_counts[kind] += 1
            return out
        if packet in self._silent:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if packet in self._products:
            n = self._products[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.dot_flops += n
        elif ins and packet not in self._moves:
            self.flops += sum(t.numel() for t in outs
                              if t.is_floating_point())
        return out

    @property
    def collective_bytes(self) -> int:
        return sum(self.coll_bytes.values())


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Counter)``: the call's result and what it
    dispatched."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, c
