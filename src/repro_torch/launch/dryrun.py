"""Multi-pod dry-run driver, ported from ``repro.launch.dryrun``.

For every (architecture × input shape) cell, run the step function once
on the production mesh (single-pod 16x16 = 256 ranks, and multi-pod
2x16x16 = 512 ranks) under the port's counter, and emit the roofline
terms as JSON rows that ``benchmarks/roofline_report.py`` renders.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Where the reference lowers and compiles with XLA on 512 forced host
devices, the port needs no device and no flag:

* the mesh is :func:`~repro_torch.launch.mesh.make_production_mesh` on a
  ``"fake"`` process group of 256 or 512 ranks in this one process (its
  collectives move nothing), destroyed at the end of each cell;
* parameters, optimizer state, caches and inputs are ``DTensor``s over
  ``meta`` local tensors of one rank's shard shape
  (:func:`~repro_torch.launch.mesh.local_shape`), laid out by the
  reference's partition specs: no memory is allocated;
* "lowering" a cell runs its step once under
  :class:`~repro_torch.roofline.counter.Counter`, which counts rank 0's
  local work and collectives (module totals are that × ranks, as the
  reference's are).

Attention is ``dense`` or ``chunked``, as in the reference's cells: the
hand-written kernels are ``ctypes`` calls, which a dispatch mode cannot
see and a ``meta`` tensor cannot run, so ``--attn-impl kernel`` raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as S
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as R
from repro_torch.roofline.counter import count
from repro_torch.train import step as TS


def arch_train_config(cfg: ArchConfig, overrides=None) -> TS.TrainConfig:
    """Per-arch defaults: microbatching + attention impl scale with size."""
    n = cfg.param_count
    micro = 8 if n > 100e9 else (4 if n > 10e9 else 1)
    kw = dict(
        microbatches=micro,
        accum_dtype="bfloat16" if n > 100e9 else "float32",
        attn_impl="dense",
        attn_chunk=1024,
    )
    if overrides:
        kw.update(overrides)
    return TS.TrainConfig(**kw)


def wants_fsdp(cfg: ArchConfig) -> bool:
    return cfg.param_count > 10e9


def _batch_axes_for(shape: ShapeConfig, mesh):
    """Drop batch axes that don't divide the global batch (e.g. long_500k
    with batch=1 stays unsharded)."""
    sizes = TM.axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    keep = []
    b = shape.global_batch
    for a in axes:
        n = sizes[a]
        if b % n == 0:
            keep.append(a)
            b //= n
    return tuple(keep)


def _prod(mesh, axes):
    sizes = TM.axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _dtensor(t, spec, mesh):
    """A meta ``DTensor`` of ``t``'s global shape and type, laid out by
    ``spec`` on ``mesh``: its local tensor is one rank's shard shape."""
    local = torch.empty(TM.local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype, device="meta")
    return L.from_local(local, mesh, TM.placements(spec, mesh), t.shape)


def distribute(tree, specs, mesh):
    """Every leaf of ``tree`` (dicts and lists of meta tensors) as a meta
    ``DTensor`` by the spec laid over it (spec trees in the port's
    layout: ``convert.unstack_specs``)."""
    if isinstance(tree, dict):
        return {k: distribute(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    return _dtensor(tree, specs, mesh)


def local_bytes(*trees) -> int:
    """One rank's bytes of every tensor in ``trees``, each counted once
    (a cache updated in place is an argument and an output): a
    ``DTensor``'s local shard, a plain tensor whole."""
    n, seen = 0, set()
    for t in pytree.tree_leaves(trees):
        if not isinstance(t, torch.Tensor) or id(t) in seen:
            continue
        seen.add(id(t))
        if L.is_dtensor(t):
            t = t.to_local()
        n += t.numel() * t.element_size()
    return n


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               overrides=None, verbose=True, compression=False,
               seq_shard=False, fsdp: str = "auto", pipeline=False):
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group: "
                           "destroy the running one first")
    mesh = TM.make_production_mesh(multi_pod=multi_pod, device="cpu")
    try:
        return lower(cfg, shape, mesh, overrides=overrides,
                     verbose=verbose, compression=compression,
                     seq_shard=seq_shard, fsdp=fsdp, pipeline=pipeline)
    finally:
        dist.destroy_process_group()


def lower(cfg: ArchConfig, shape: ShapeConfig, mesh, *, overrides=None,
          verbose=False, compression=False, seq_shard=False,
          fsdp: str = "auto", pipeline=False):
    """:func:`lower_cell`'s work for any config, shape and mesh (axes
    ``data``/``model``, and ``pod`` for ``compression``/``pipeline``) on
    a running fake group: the tests lower reduced configs on small
    meshes with it."""
    if (overrides or {}).get("attn_impl") == "kernel":
        raise ValueError(
            "--attn-impl kernel cannot be dry-run: the hand-written "
            "kernels are ctypes calls, which the counter's dispatch mode "
            "cannot see and meta tensors cannot run; use dense or chunked")
    chips = mesh.size()
    use_fsdp = {"auto": wants_fsdp(cfg), "on": True, "off": False}[fsdp]
    rules = TM.make_rules(mesh, fsdp=use_fsdp, seq=seq_shard)
    batch_axes = _batch_axes_for(shape, mesh)
    # kv replication (model_size-aware pspecs) stays off, as in the
    # reference, which measured it as a net loss for train and decode
    rules = T.ShardRules(batch=batch_axes, model=rules.model,
                         fsdp=rules.fsdp, seq=rules.seq,
                         moe_groups=_prod(mesh, batch_axes), model_size=1)
    return _lower_cell_inner(cfg, shape, cfg.name, shape.name, mesh, chips,
                             rules, torch.bfloat16, time.time(), overrides,
                             verbose, compression, pipeline)


def _lower_cell_inner(cfg, shape, arch_name, shape_name, mesh, chips, rules,
                      dtype, t0, overrides, verbose, compression,
                      pipeline=False):
    if pipeline:
        assert shape.kind == "train" and "pod" in mesh.mesh_dim_names, \
            "--pipeline needs a train shape on the multi-pod mesh"
        args, out, counter = _lower_pipeline(cfg, shape, mesh, rules, dtype,
                                             overrides)
    elif shape.kind == "train":
        tc = arch_train_config(cfg, overrides)
        if shape.global_batch % (max(1, _prod(mesh, rules.batch))
                                 * tc.microbatches):
            tc = dataclasses.replace(tc, microbatches=1)
        if compression:
            tc = dataclasses.replace(tc, grad_compression="int8_pod")
        pshapes, sshapes = _train_shapes(cfg, tc, dtype)
        pspec, sspec = TS.train_state_pspecs(cfg, tc, rules, pshapes)
        params = distribute(pshapes,
                            convert.unstack_specs(pspec, pshapes), mesh)
        state = distribute(sshapes,
                           convert.unstack_specs(sspec, sshapes), mesh)
        (inputs,) = S.input_specs(cfg, shape, dtype)
        # the int8 step's ranks each take their slice of the batch that
        # all pods are given: laid out by the rules without 'pod'
        bspec = S.input_pspecs(cfg, dataclasses.replace(
            rules, batch=tuple(a for a in rules.batch if a != "pod"))
            if compression else rules)
        batch = {k: _dtensor(v, bspec[k], mesh) for k, v in inputs.items()}
        if compression:
            step = TS.make_compressed_train_step(cfg, tc,
                                                 mesh.get_group("pod"),
                                                 rules)
        else:
            step = TS.make_train_step(cfg, tc, rules)
        args = (params, state, batch)
        out, counter = count(step, *args)
    elif shape.kind == "prefill":
        (inputs,) = S.input_specs(cfg, shape, dtype)
        pshapes = T.param_shapes(cfg, dtype)
        pspec = convert.unstack_specs(T.param_pspecs(cfg, rules), pshapes)
        params = distribute(pshapes, pspec, mesh)
        bspec = S.input_pspecs(cfg, rules)
        batch = {k: _dtensor(v, bspec[k], mesh) for k, v in inputs.items()}
        impl = "chunked" if shape.seq_len > 8192 else "dense"

        def prefill(params, batch):
            with torch.no_grad():
                logits, _ = T.forward(params, cfg, batch, impl=impl,
                                      chunk=1024, rules=rules, remat=False)
            return logits

        args = (params, batch)
        out, counter = count(prefill, *args)
    else:  # decode
        inputs, cache = S.input_specs(cfg, shape, dtype)
        pshapes = T.param_shapes(cfg, dtype)
        pspec = convert.unstack_specs(T.param_pspecs(cfg, rules), pshapes)
        params = distribute(pshapes, pspec, mesh)
        cspec = T.cache_pspecs(cfg, rules)
        cache = {k: _dtensor(v, cspec[k], mesh) for k, v in cache.items()}
        batch = {}
        for k, v in inputs.items():
            if k == "length":
                continue
            spec = (T.P(None, rules.batch, None) if k == "positions"
                    else T.P(rules.batch, *(None,) * (v.ndim - 1)))
            batch[k] = _dtensor(v, spec, mesh)
        # the position is the host int the port's decode_step reads; the
        # reference's static-shape step attends over the whole cache, so
        # the dry-run writes the last slot and attends over all of it
        batch["length"] = shape.seq_len - 1

        def serve_step(params, cache, batch):
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, batch, rules=rules)

        args = (params, cache, batch)
        out, counter = count(serve_step, *args)

    t_lower = time.time() - t0
    cost = R.analyze(counter, chips=chips)
    roof = R.Roofline(
        arch=arch_name, shape=shape_name,
        mesh="x".join(str(n) for n in mesh.shape),
        chips=chips, hlo_flops=cost["flops"], hlo_bytes=cost["bytes"],
        collective_bytes=cost["collective_bytes"],
        model_flops=R.model_flops(cfg, shape),
        # one rank's arguments and outputs from their placements; the
        # activations' temporaries are not counted (the reference's
        # figure adds XLA's temp buffer)
        per_device_hbm=float(local_bytes(args, out)),
        dot_flops=cost["dot_flops"], coll_counts=cost["coll_counts"],
        dtype=str(dtype).removeprefix("torch."))
    if verbose:
        print(f"== {arch_name} x {shape_name} on {roof.mesh} "
              f"({chips} chips) ==")
        print(f"   counted in {t_lower:.1f}s")
        print(f"   per-rank arguments + outputs: "
              f"{roof.per_device_hbm / 1e9:.3f} GB")
        print(f"   hlo_flops={cost['flops']:.3e} "
              f"(dot {cost['dot_flops']:.3e}) bytes={cost['bytes']:.3e}")
        print(f"   collective_bytes={cost['collective_bytes']:.3e} "
              f"counts={cost['coll_counts']}")
        r = roof.row()
        print(f"   t_compute={r['t_compute_s']:.4f}s "
              f"t_memory={r['t_memory_s']:.4f}s "
              f"t_collective={r['t_collective_s']:.4f}s "
              f"-> bottleneck={r['bottleneck']}")
        print(f"   useful_flop_ratio={r['useful_flop_ratio']:.3f} "
              f"roofline_fraction={r['roofline_fraction']:.3f}")
    return roof


def _lower_pipeline(cfg, shape, mesh, rules, dtype, overrides):
    """GPipe over the 'pod' axis: blocks stage-sharded, TP inside stages.

    The port's one-stage-a-rank pipeline (``train.pipeline``, group = the
    fake group's 'pod' subgroup): this process is rank 0, so it runs
    stage 0, whose parameters (its L/S blocks and the replicated
    embed/ln_f/head), state and batch are DTensors on the (data, model)
    sub-mesh under the inner rules.  The hops are the wire's real
    ``dist.send``/``recv`` on the fake group, which carries them (and
    moves nothing): each send is counted as one collective-permute of the
    rank's activation or gradient shard, (S − 1) hops a microbatch each
    way.  Rank 0 does stage 0's work, so the module totals (× ranks)
    leave out the last stage's head and loss."""
    from repro_torch.train.pipeline import (PipelineConfig, init_pp_state,
                                            make_pp_train_step)
    tc = arch_train_config(cfg, overrides)
    sizes = TM.axis_sizes(mesh)
    pc = PipelineConfig(n_stages=sizes["pod"],
                        microbatches=max(tc.microbatches, 4))
    # inner (per-stage) rules: data/model only
    inner = T.ShardRules(batch=tuple(a for a in rules.batch if a != "pod"),
                         model=rules.model, fsdp=rules.fsdp, moe_groups=1)
    group = mesh.get_group("pod")
    sub = mesh["data", "model"]
    pshapes, sshapes = init_pp_state(cfg, tc, pc, stage=dist.get_rank(group),
                                     device="meta", dtype=dtype)
    pspec, sspec = TS.train_state_pspecs(cfg, tc, inner, pshapes)
    params = distribute(pshapes, convert.unstack_specs(pspec, pshapes), sub)
    state = distribute(sshapes, convert.unstack_specs(sspec, sshapes), sub)
    (inputs,) = S.input_specs(cfg, shape, dtype)
    bspec = S.input_pspecs(cfg, inner)
    batch = {k: _dtensor(v, bspec[k], sub) for k, v in inputs.items()}
    step = make_pp_train_step(cfg, tc, pc, inner, group)
    args = (params, state, batch)
    out, counter = count(step, *args)
    return args, out, counter


def _train_shapes(cfg, tc, dtype):
    return TS.train_state_shapes(cfg, tc, dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--pipeline", action="store_true",
                    help="GPipe over the pod axis (multi-pod train only)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--attn-impl", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    if args.micro:
        overrides["microbatches"] = args.micro
    if args.attn_impl:
        overrides["attn_impl"] = args.attn_impl

    cells = []
    if args.all:
        for a in list_archs():
            cfg = get_arch(a)
            for sname in SHAPES:
                if sname in cfg.skip_shapes:
                    print(f"-- skip {a} x {sname} "
                          f"(sub-quadratic requirement; see DESIGN.md)")
                    continue
                cells.append((a, sname))
    else:
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    rows, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            try:
                roof = lower_cell(arch, shape, multi_pod=mp,
                                  overrides=overrides or None,
                                  compression=args.compression,
                                  seq_shard=args.seq_shard,
                                  fsdp=args.fsdp,
                                  pipeline=args.pipeline)
                rows.append(roof.row())
            except Exception as e:  # noqa: BLE001 — report all failures
                failures.append((arch, shape, mp, repr(e)[:500]))
                print(f"!! FAIL {arch} x {shape} multi_pod={mp}: "
                      f"{repr(e)[:300]}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1)
    print(f"\n{len(rows)} cells OK, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
