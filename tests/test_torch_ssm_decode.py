"""The fused SSM decode's plain version on the CPU: against the port's
op-by-op ``layers.ssm_decode`` over consecutive steps (bit for bit: both
are ``ssm_decode.step``, the plain version writing its states in place),
against a float64 recurrence and the reference's
``ssm_decode``; ``decode_step(impl="kernel")`` against ``impl="dense"``
on the tiny hybrid, pattern and Mamba2 configurations; and what the
wrapper refuses.

Tolerances: 1e-5 against the reference in fp32 (its conv and einsums add
in other orders), 2e-5 against float64."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_decode as tsd
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

B, DM = 3, 128
STEPS = 4
# (d_state, head_dim, n_groups, activation type)
CASES = [(ds, hd, ng, dt) for ds in (16, 128) for hd in (16, 64)
         for ng in (1, 2) for dt in ("fp32", "bf16")]
TYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _config(ds, hd, ng, module=tconfigs):
    """mamba2-130m cut to d_model 128 at these SSM widths."""
    cfg = module.get_arch("mamba2-130m").reduced()
    return dataclasses.replace(
        cfg, d_model=DM, ssm=dataclasses.replace(
            cfg.ssm, d_state=ds, head_dim=hd, n_groups=ng))


def _layer(case, seed=0):
    """The port's config, the mixer's params (conv_b, dt_bias and D drawn,
    so that no term is zero), x for each step, and the two states."""
    ds, hd, ng, dt = case
    dtype = TYPES[dt]
    cfg = _config(ds, hd, ng)
    g = torch.Generator().manual_seed(seed)
    p = TL.ssm_init(g, cfg, dtype, "cpu")
    p["conv_w"] = (torch.randn(p["conv_w"].shape, generator=g) * 0.5).to(dtype)
    p["conv_b"] = (torch.randn(p["conv_b"].shape, generator=g) * 0.1).to(dtype)
    p["D"] = torch.randn(p["D"].shape, generator=g)
    d_in, nh, conv_dim = TL.ssm_dims(cfg)
    xs = [torch.randn((B, 1, DM), generator=g).to(dtype) for _ in range(STEPS)]
    state = torch.randn((B, nh, hd, ds), generator=g)
    conv = torch.randn((B, cfg.ssm.d_conv - 1, conv_dim), generator=g).to(dtype)
    return cfg, p, xs, state, conv


@pytest.mark.parametrize("case", CASES)
def test_kernel_step_is_the_op_by_op_step(case):
    """``layers.ssm_decode(impl="kernel")`` (the plain version, in place)
    against the op-by-op step, over consecutive steps: the output, the
    state and the shifted conv window equal bit for bit at every step, the
    states written over the ones passed in."""
    cfg, p, xs, state, conv = _layer(case)
    st_k, cv_k = state.clone(), conv.clone()
    for x in xs:
        got, st, cv = TL.ssm_decode(p, x, st_k, cv_k, cfg, impl="kernel")
        want, state, conv = TL.ssm_decode(p, x, state, conv, cfg)
        assert st is st_k and cv is cv_k
        assert torch.equal(got, want)
        assert torch.equal(st_k, state) and torch.equal(cv_k, conv)


def _recurrence64(p, xbc, dt_raw, state, conv, ng):
    """The step in float64, written out: (y (B, d_in), state, window)."""
    b, nh, hd, ds = state.shape
    d_in = nh * hd
    win = torch.cat([conv.double(), xbc[:, None].double()], 1)
    u = (win * p["conv_w"].double()).sum(1) + p["conv_b"].double()
    u = u * torch.sigmoid(u)
    x = u[:, :d_in].reshape(b, nh, hd)
    bc = u[:, d_in:].reshape(b, 2, ng, ds)
    rep = nh // ng
    Bm = bc[:, 0].repeat_interleave(rep, 1)
    Cm = bc[:, 1].repeat_interleave(rep, 1)
    dt = torch.nn.functional.softplus(dt_raw.double()
                                      + p["dt_bias"].double())
    da = torch.exp(-dt * torch.exp(p["A_log"].double()))
    new = (da[..., None, None] * state.double()
           + dt[..., None, None] * x[..., None] * Bm[:, :, None])
    y = (new * Cm[:, :, None]).sum(-1) + x * p["D"].double()[:, None]
    return y.reshape(b, d_in), new, win[:, 1:]


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "fp32"])
def test_ops_entry_point_is_the_recurrence(case):
    """``ops.ssm_decode`` on fp32 inputs against the step in float64: y
    (before the gating) and the state within 2e-5, the window shifted
    exactly, over consecutive steps."""
    cfg, p, xs, state, conv = _layer(case)
    g = torch.Generator().manual_seed(7)
    d_in, nh, conv_dim = TL.ssm_dims(cfg)
    for _ in range(STEPS):
        xbc = torch.randn((B, conv_dim), generator=g)
        dt_raw = torch.randn((B, nh), generator=g)
        want_y, want_st, want_cv = _recurrence64(p, xbc, dt_raw, state, conv,
                                                 cfg.ssm.n_groups)
        y = ops.ssm_decode(xbc, dt_raw, conv, state, p["conv_w"], p["conv_b"],
                           p["dt_bias"], p["A_log"], p["D"],
                           n_groups=cfg.ssm.n_groups)
        assert y.shape == (B, 1, d_in) and y.dtype == torch.float32
        np.testing.assert_allclose(y[:, 0].numpy(), want_y.numpy(),
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(state.numpy(), want_st.numpy(), atol=2e-5,
                                   rtol=2e-5)
        assert torch.equal(conv.double(), want_cv)


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "fp32"][::2])
def test_kernel_step_matches_the_reference(case):
    """The port's ``impl="kernel"`` step against the reference's
    ``ssm_decode`` on the same numbers, three steps: the output and both
    states within 1e-5."""
    ds, hd, ng, _ = case
    cfg, p, xs, state, conv = _layer(case)
    jcfg = _config(ds, hd, ng, jconfigs)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    # copies: the port's step writes the states in place
    jst, jcv = jnp.array(state.numpy().copy()), jnp.array(conv.numpy().copy())
    for x in xs[:3]:
        got, state, conv = TL.ssm_decode(p, x, state, conv, cfg,
                                         impl="kernel")
        want, jst, jcv = JL.ssm_decode(jp, jnp.asarray(x.numpy()), jst, jcv,
                                       jcfg)
        for a, b in ((got, want), (state, jst), (conv, jcv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


def _step_inputs(cfg, n, g, b):
    inp = {"length": torch.tensor(n, dtype=torch.int32)}
    inp["tokens"] = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
    return inp


@pytest.mark.parametrize("arch,conv_type", [
    ("hymba-1.5b", torch.float32), ("granite-4.0-h-small", torch.float32),
    ("mamba2-130m", torch.float32), ("mamba2-130m", torch.bfloat16)])
def test_decode_step_kernel_matches_dense(arch, conv_type):
    """``decode_step(impl="kernel")`` on a CPU cache against
    ``impl="dense"``, four steps from a filled cache: the logits equal and
    every cache entry equal after each (a bf16 conv window is widened to
    the activations' fp32 on both paths)."""
    cfg = tconfigs.get_arch(arch).reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(2)
    cache = TT.init_cache(cfg, B, 24, dtype=torch.bfloat16, device="cpu")
    for name, t in cache.items():
        cache[name] = torch.randn(t.shape, generator=g).to(
            conv_type if name == "conv" else t.dtype)
    dense = {k: v.clone() for k, v in cache.items()}
    for n in range(12, 16):
        inp = _step_inputs(cfg, n, g, B)
        got, cache = TT.decode_step(params, cfg, cache, inp, impl="kernel")
        want, dense = TT.decode_step(params, cfg, dense, inp)
        assert torch.equal(got, want), (arch, n)
        assert set(cache) == set(dense)
        for name, t in dense.items():
            assert cache[name].dtype == t.dtype, name
            assert torch.equal(cache[name], t), (arch, n, name)


def test_hybrid_step_reports_its_ssm_region(monkeypatch):
    """hymba's decode step records one ``mixer.ssm`` span a layer."""
    from repro_torch.spans import REGISTRY, spans_between
    monkeypatch.setattr(REGISTRY, "spans_on", True)
    cfg = tconfigs.get_arch("hymba-1.5b").reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    cache = TT.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    inp = _step_inputs(cfg, 3, torch.Generator().manual_seed(0), 2)
    before = REGISTRY.snapshot()
    TT.decode_step(params, cfg, cache, inp, impl="kernel")
    spans = spans_between(before, REGISTRY.snapshot())
    assert spans["mixer.ssm"]["count"] == cfg.n_layers


def _args(case=(16, 16, 2, "fp32")):
    cfg, p, xs, state, conv = _layer(case)
    d_in, nh, conv_dim = TL.ssm_dims(cfg)
    xbc = torch.zeros((B, conv_dim), dtype=TYPES[case[3]])
    dt_raw = torch.zeros((B, nh), dtype=TYPES[case[3]])
    return [xbc, dt_raw, conv, state, p["conv_w"], p["conv_b"], p["dt_bias"],
            p["A_log"], p["D"]], cfg.ssm.n_groups


def _refused(args, ng, err, match):
    for fn in (ops.ssm_decode, tsd.launch):
        with pytest.raises(err, match=match):
            fn(*args, n_groups=ng)


@pytest.mark.parametrize("what", ["d_state", "head_dim", "groups",
                                  "conv_dim", "d_conv", "xbc", "params"])
def test_kernel_refuses_a_wrong_shape(what):
    """A shape off the kernel's instances, or inputs that do not fit one
    another, raise on either device's path before anything is written."""
    args, ng = _args()
    b, nh, hd, ds = args[3].shape
    if what == "d_state":
        args[3] = torch.zeros((b, nh, hd, 32))
    elif what == "head_dim":
        args[3] = torch.zeros((b, nh * hd // 32, 32, ds))
    elif what == "groups":
        ng = 3
    elif what == "conv_dim":
        args[2] = args[2][..., 1:].contiguous()
    elif what == "d_conv":
        args[2] = torch.zeros((b, 8, args[2].shape[-1]))
    elif what == "xbc":
        args[0] = args[0][:, 1:]
    else:
        args[8] = torch.zeros((nh + 1,))
    before = [a.clone() for a in args]
    _refused(args, ng, ValueError, None)
    assert all(torch.equal(a, w) for a, w in zip(args, before))


@pytest.mark.parametrize("what,match", [
    ("state", "fp32"), ("narrow conv", "widen"), ("dt_raw", "as xbc is"),
    ("int", "fp32 or bf16")])
def test_kernel_refuses_a_wrong_type(what, match):
    """A bf16 state, a conv window narrower than xbc (the caller widens
    the cache first), inputs of mixed types, or another type raise."""
    args, ng = _args()
    if what == "state":
        args[3] = args[3].bfloat16()
    elif what == "narrow conv":
        args[2] = args[2].bfloat16()
    elif what == "dt_raw":
        args[1] = args[1].bfloat16()
    else:
        args[0], args[1] = args[0].long(), args[1].long()
    _refused(args, ng, TypeError, match)


@pytest.mark.parametrize("which", [2, 3])
def test_kernel_refuses_a_non_contiguous_cache(which):
    """A state or window that is not contiguous cannot be updated in
    place: it raises."""
    args, ng = _args()
    t = args[which]
    wide = torch.zeros(t.shape[:-1] + (2 * t.shape[-1],), dtype=t.dtype)
    args[which] = wide[..., ::2]
    _refused(args, ng, ValueError, "contiguous")


def test_launch_needs_cuda_tensors():
    args, ng = _args()
    with pytest.raises(ValueError, match="CUDA"):
        tsd.launch(*args, n_groups=ng)


def test_kernel_refuses_a_dtensor_cache_and_the_step_stays_op_by_op():
    """The wrapper raises on a DTensor state; ``decode_step(impl=
    "kernel")`` on a DTensor Mamba2 cache keeps the op-by-op step and
    gives ``impl="dense"``'s logits."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = tconfigs.get_arch("mamba2-130m").reduced()
    params = TT.init_params(cfg, device="cpu", seed=0)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        args, ng = _args()
        args[3] = DTensor.from_local(args[3], mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ops.ssm_decode(*args, n_groups=ng)
        plain = TT.init_cache(cfg, B, 24, dtype=torch.float32, device="cpu")
        for t in plain.values():
            t.normal_(generator=torch.Generator().manual_seed(1))
        cache = {k: DTensor.from_local(v.clone(), mesh, [Replicate()])
                 for k, v in plain.items()}
        inp = _step_inputs(cfg, 3, torch.Generator().manual_seed(0), B)
        got, cache = TT.decode_step(params, cfg, cache, inp, impl="kernel")
        want, plain = TT.decode_step(params, cfg, plain, inp)
        assert torch.equal(got.full_tensor() if isinstance(got, DTensor)
                           else got, want)
        for name, t in plain.items():
            assert torch.equal(cache[name].full_tensor(), t), name
    finally:
        dist.destroy_process_group()
