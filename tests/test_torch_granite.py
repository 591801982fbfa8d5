"""granite-4.0-h-small in the port, on the CPU at a small size with seeded
random weights: Mamba2 and NoPE-attention layers by a per-layer pattern,
the four multipliers, an expert layer that holds fewer experts than its
router scores, dropless routing, and the shared expert.

The port is held against the benchmark's plain reference of this
configuration (``portbench/reference/hybrid_moe.py``, float32 PyTorch
that imports nothing of the program), so this file puts the checkout's
root on ``sys.path`` itself.  Tolerances, with their reasons:

* full forward, 1e-4 relative and 1e-5 absolute on logits of order 1e-2:
  both sides are float32; only the order of the sums differs (the
  chunked SSD against the reference's chunk formula, the combine's gate
  sums, the matmuls' blocking), as in the benchmark's own test of the
  decoder reference;
* decode through the cache against the reference's ``cache_rows_from``
  form, the same: the reference follows the bfloat16 cache's roundings,
  so what is left is again the order of float32 sums;
* the eight ranks' shares of one expert layer against the uncut layer,
  1e-6 absolute on outputs of order 1e-2: float32 sums of the same
  products, added across ranks in another order;
* the scale's default, bit for bit: the division by √D as before."""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights  # noqa: E402
from portbench.reference import hybrid_moe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.spans import NodeTally, region, tallying  # noqa: E402

NAME = "granite-4.0-h-small"
SEED = 2 ** 31 + 17
FWD = dict(rtol=1e-4, atol=1e-5)
LAYERS = ("mamba", "attention", "mamba", "mamba")


def small():
    """The reduced configuration at 4 layers, one of them attention; 2 of
    4 experts held, every multiplier as published."""
    cfg = tconfigs.get_arch(NAME).reduced()
    return dataclasses.replace(cfg, n_layers=len(LAYERS), layer_types=LAYERS)


def file_of(arch) -> dict:
    """The configuration dict the reference reads, as a benchmark file
    states it."""
    return {"name": arch.name, "n_layers": arch.n_layers,
            "d_model": arch.d_model, "n_heads": arch.n_heads,
            "n_kv_heads": arch.n_kv_heads, "d_head": arch.head_dim,
            "d_ff": arch.d_ff, "vocab_size": arch.vocab_size,
            "padded_vocab_size": arch.padded_vocab_size,
            "norm_eps": arch.norm_eps, "layer_types": list(arch.layer_types),
            "attention_multiplier": arch.attention_multiplier,
            "embedding_multiplier": arch.embedding_multiplier,
            "residual_multiplier": arch.residual_multiplier,
            "logits_scaling": arch.logits_scaling,
            "ssm": dataclasses.asdict(arch.ssm),
            "moe": dataclasses.asdict(arch.moe)}


@pytest.fixture(scope="module")
def model():
    arch = small()
    cfg = file_of(arch)
    params = weights.make(cfg, TT.param_shapes(arch, torch.float32), SEED,
                          torch.device("cpu"))
    return arch, cfg, params


def _tokens(arch, n, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, arch.vocab_size, (2, n)))


def test_the_configuration_is_as_published_and_stays_out_of_the_zoo():
    cfg = tconfigs.get_arch(NAME)
    assert NAME not in tconfigs.list_archs()
    assert [i for i in range(40) if cfg.mixer(i) == "gqa"] == [5, 15, 25, 35]
    assert cfg.n_mixers("none") == 36
    assert [cfg.state_index(i) for i in (4, 5, 6, 15, 35, 39)] == [
        4, 0, 5, 1, 3, 35]
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.held, cfg.moe.dropless) == (72, 10, 768, 9, True)
    assert (cfg.attention_multiplier, cfg.embedding_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling) == (
        1 / 128, 12.0, 0.22, 16.0)
    # 36 Mamba2 mixers, 4 attention layers, 9 experts, the shared expert,
    # the routers and the tied embedding: 8.43 B of the published 32.2 B
    assert cfg.param_count == 8_425_634_304
    meta = TT.param_shapes(cfg, torch.float32)
    assert TT.param_count(meta) == cfg.param_count
    assert tuple(meta["blocks"][0]["moe"]["w_gate"].shape) == (9, 4096, 768)
    assert tuple(meta["blocks"][0]["moe"]["router"].shape) == (4096, 72)
    assert set(meta["blocks"][5]) == {"ln1", "attn", "ln2", "moe"}
    assert set(meta["blocks"][6]) == {"ln1", "ssm", "ln2", "moe"}


def test_reduced_keeps_both_layer_kinds_and_fewer_experts_held():
    cfg = tconfigs.get_arch(NAME).reduced()
    assert set(cfg.layer_types) == {"mamba", "attention"}
    assert cfg.moe.held < cfg.moe.n_experts
    assert cfg.param_count == TT.param_count(
        TT.init_params(cfg, device="cpu"))


@pytest.mark.parametrize("impl", ["dense", "chunked", "kernel"])
def test_forward_matches_the_plain_reference(model, impl):
    arch, cfg, params = model
    tokens = _tokens(arch, 64)
    with torch.no_grad():
        got = TT.forward(params, arch, {"tokens": tokens}, impl=impl,
                         chunk=32)[0]
        want = hybrid_moe.forward(params, cfg, tokens)
    torch.testing.assert_close(got, want, **FWD)


def _served_rows(params, arch, tokens, prompt, steps, impl):
    """Prefill ``prompt`` tokens, then ``steps - 1`` decode steps of the
    next tokens through the cache: the logits of each served position."""
    logits, cache = engine.prefill_with_cache(
        params, arch, {"tokens": tokens[:, :prompt]}, prompt + steps,
        impl="kernel")
    rows = [logits[:, -1]]
    for i in range(steps - 1):
        step = {"tokens": tokens[:, prompt + i:prompt + i + 1],
                "length": torch.tensor(prompt + i)}
        out, cache = TT.decode_step(params, arch, cache, step, impl=impl)
        rows.append(out[:, 0])
    return torch.stack(rows, 1)


@pytest.mark.parametrize("impl", TT.DECODE_IMPLS)
def test_decode_through_the_cache_matches_the_reference(model, impl):
    """Every decoded position's logits, from the prefill's last on,
    against the reference's rows in the cache's arithmetic."""
    arch, cfg, params = model
    prompt, steps = 32, 10
    tokens = _tokens(arch, prompt + 32, seed=2)
    with torch.no_grad():
        got = _served_rows(params, arch, tokens, prompt, steps, impl)
        want = hybrid_moe.forward(params, cfg, tokens,
                                  cache_rows_from=prompt)
    torch.testing.assert_close(got, want[:, prompt - 1:prompt - 1 + steps],
                               **FWD)


def test_the_server_serves_the_references_tokens(model):
    """BatchServer (prefill and decode, impl "kernel"'s plain versions):
    every served token is the reference's first at its position, and
    the decode steps' routed pairs are those the reference routes to the
    held experts at the same positions."""
    arch, cfg, params = model
    prompt, new = 32, 9
    srv = engine.BatchServer(params, arch, n_slots=2, max_len=prompt + new,
                             device="cpu")
    prompts = _tokens(arch, prompt, seed=3).numpy().astype(np.int32)
    reqs = [srv.submit(engine.Request(f"r{i}", p, max_new_tokens=new))
            for i, p in enumerate(prompts)]
    srv.run(max_requests=2, idle_timeout_s=0.5)
    seq = np.stack([np.concatenate([r.prompt, r.result_tokens[:-1]])
                    for r in reqs])
    ids = torch.zeros((2, 64), dtype=torch.long)
    ids[:, :seq.shape[1]] = torch.from_numpy(seq.astype(np.int64))
    routed = []
    experts = hybrid_moe.experts

    def counted(lp, x, c):
        top = (x.reshape(-1, x.shape[-1]) @ lp["router"]).topk(
            c["moe"]["top_k"], dim=-1)[1].reshape(*x.shape[:2], -1)
        # the decode steps' positions: the prompt's first served token on
        rows = top[:, prompt:prompt + new - 1]
        routed.append(int((rows < c["moe"]["experts_held"]).sum()))
        return experts(lp, x, c)
    with torch.no_grad():
        hybrid_moe.experts = counted
        try:
            ref = hybrid_moe.forward(params, cfg, ids, cache_rows_from=prompt)
        finally:
            hybrid_moe.experts = experts
    served = ref[:, prompt - 1:prompt - 1 + new].argmax(-1)
    assert served.tolist() == [r.result_tokens for r in reqs]
    wave = srv.waves[0]
    assert wave["moe_routed"] == sum(routed) > 0
    assert "moe_rows" not in wave


def test_eight_ranks_shares_add_up_to_the_uncut_layer():
    """One expert layer of 16 experts, top 4, over 8 ranks of 2: each
    rank holds its 2 experts first (the router's columns put them there,
    which changes no gate), computes its part with no shared expert; the
    parts and the shared expert once add up to the uncut layer's output,
    dropless on both sides."""
    base = small()
    moe = dataclasses.replace(base.moe, n_experts=16, top_k=4,
                              experts_held=0, dropless=True)
    whole = dataclasses.replace(base, moe=moe)
    gen = torch.Generator().manual_seed(7)
    p = TL.moe_init(gen, whole, torch.float32, torch.device("cpu"))
    x = torch.randn((2, 12, whole.d_model), generator=gen)
    with torch.no_grad():
        want, _ = TL.moe_forward(p, x, whole)
        share = dataclasses.replace(
            whole, moe=dataclasses.replace(moe, experts_held=2,
                                           dense_residual=False))
        total = TL.ffn_forward(p["dense"], x, whole.ffn_kind)
        for rank in range(8):
            mine = [2 * rank, 2 * rank + 1]
            order = mine + [e for e in range(16) if e not in mine]
            pr = {"router": p["router"][:, order]}
            for name in ("w_gate", "w_up", "w_down"):
                pr[name] = p[name][mine]
            part, _ = TL.moe_forward(pr, x, share)
            total = total + part
    torch.testing.assert_close(total, want, rtol=0, atol=1e-6)


def test_absent_experts_add_nothing_and_nothing_is_dropped():
    arch = small()
    assert TL.moe_capacity(arch, 1000) == 1000
    gen = torch.Generator().manual_seed(9)
    p = TL.moe_init(gen, arch, torch.float32, torch.device("cpu"))
    x = torch.randn((1, 40, arch.d_model), generator=gen)
    counter = torch.zeros((), dtype=torch.int64)
    with torch.no_grad(), TL.counting(counter):
        y, aux = TL.moe_forward(p, x, arch)
    ids = TL.moe_route(p, x, arch.moe.top_k)[3]
    held = ids < arch.moe.held
    assert int(counter) == int(held.sum())
    # the share is an fp32 quotient: one rounding of 2^-24
    assert float(aux["dropped_frac"]) == pytest.approx(
        1.0 - int(held.sum()) / held.numel(), rel=2 ** -23)
    # a token whose experts are all absent gets the shared expert alone
    shared = TL.ffn_forward(p["dense"], x, arch.ffn_kind)
    alone = ~held.any(-1)[0]
    assert alone.any()
    torch.testing.assert_close(y[0, alone], shared[0, alone], rtol=0,
                               atol=0)


# the parent commit's reduced init_params(seed=0) of the ten zoo archs:
# leaves, elements, Σ (i + 1) · sum(leaf i) in float64, and
# param_count / active_param_count reduced and at full size
TREES = {
    'arctic-480b': (29, 156480, 3424.4135608628467, 156480, 131904,
                    476850275328, 15584314368),
    'hymba-1.5b': (41, 163248, 18030.28110681986, 162992, 162992,
                   1640872320, 1640872320),
    'internlm2-1.8b': (21, 106816, 2940.9450546812996, 106816, 106816,
                       1889110016, 1889110016),
    'mamba2-130m': (20, 72752, 4195.92284260554, 72880, 72880, 129001920,
                    129001920),
    'minicpm3-4b': (27, 107936, 4968.718575574228, 107936, 107936,
                    4261902848, 4261902848),
    'mistral-nemo-12b': (21, 106816, 2940.9450546812996, 106816, 106816,
                         12247782400, 12247782400),
    'musicgen-medium': (19, 188736, 2731.9914241209294, 188736, 188736,
                        1384269312, 1384269312),
    'nemotron-4-340b': (19, 90432, 2830.8563569585617, 90432, 90432,
                        341025638400, 341025638400),
    'qwen2-vl-2b': (20, 90432, 2624.9554473199546, 106816, 106816,
                    1777030656, 1777030656),
    'qwen3-moe-235b-a22b': (23, 107328, 3066.9919002616907, 107328, 82752,
                            235093610496, 22190739456),
}


@pytest.mark.parametrize("arch", sorted(TREES))
def test_the_zoo_parameter_trees_are_unchanged(arch):
    full = tconfigs.get_arch(arch)
    cfg = full.reduced()
    leaves = pytree.tree_leaves(TT.init_params(cfg, device="cpu", seed=0))
    fp = sum((i + 1) * float(t.double().sum())
             for i, t in enumerate(leaves))
    assert (len(leaves), sum(t.numel() for t in leaves), fp,
            cfg.param_count, cfg.active_param_count, full.param_count,
            full.active_param_count) == TREES[arch]
    assert full.attn_kind != "pattern" and full.layer_types == ()
    if full.moe is not None:
        assert full.moe.held == full.moe.n_experts and not full.moe.dropless


def _old_scores(q, k):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(),
                        k.float()) / math.sqrt(q.shape[-1])


def test_the_scale_default_is_todays_attention_bit_for_bit():
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 9, 4, 32), generator=g)
    k = torch.randn((2, 9, 2, 32), generator=g)
    v = torch.randn((2, 9, 2, 32), generator=g)
    kr, vr = (TL._repeat_kv(t, 2) for t in (k, v))
    mask = torch.ones(9, 9, dtype=torch.bool).tril()
    p = torch.softmax(_old_scores(q, kr).masked_fill(~mask, float("-inf")),
                      dim=-1)
    old = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    assert torch.equal(TL.attention_dense(q, k, v), old)
    assert torch.equal(TL.attention_dense(q, k, v, scale=None), old)
    assert not torch.equal(TL.attention_dense(q, k, v, scale=1 / 128), old)
    # the flash plain version: the default is 1/√D itself
    assert torch.equal(tfa.plain(q, k, v),
                       tfa.plain(q, k, v, scale=1.0 / math.sqrt(32)))
    # one decode step, op by op and through the fused plain version
    kc = torch.randn((2, 12, 2, 32), generator=g)
    vc = torch.randn((2, 12, 2, 32), generator=g)
    q1 = q[:, :1]
    sc = torch.einsum("bqgrd,bkgd->bgrqk", q1.reshape(2, 1, 2, 2, 32),
                      kc) / math.sqrt(32)
    sc = sc.masked_fill(~(torch.arange(12) < 7), float("-inf"))
    old = torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(sc, -1),
                       vc).reshape(2, 1, 4, 32)
    assert torch.equal(TL.attention_decode(q1, kc, vc, 7), old)
    out = tda.plain(q[:, 0], k[:, 0], v[:, 0], kc.clone(), vc.clone(), 6,
                    None, None, ring=False)
    kw = kc.clone()
    kw[:, 6], vw = k[:, 0], vc.clone()
    vw[:, 6] = v[:, 0]
    sc = torch.einsum("bgrd,bkgd->bgrk", q[:, 0].reshape(2, 2, 2, 32),
                      kw[:, :7]) / math.sqrt(32)
    old = torch.einsum("bgrk,bkgd->bgrd", torch.softmax(sc, -1),
                       vw[:, :7]).reshape(2, 1, 128)
    assert torch.equal(out, old)


def test_a_region_counts_the_kernel_nodes_a_capture_gains_in_it():
    """A region under a tally counts what the tally's read gains between
    its entry and its exit, summed over its entries; with no tally it is
    the plain span."""
    held = set()
    tally = NodeTally(lambda: set(held))
    with tallying(tally):
        for layer in range(3):
            held.add(("other", layer))
            with region("moe.route"):
                held.update({("route", layer, i) for i in range(4)})
            with region("moe.shared"):
                held.add(("shared", layer))
    assert tally.nodes == {"moe.route": 12, "moe.shared": 3}
    with region("moe.route"):
        pass
    assert tally.nodes == {"moe.route": 12, "moe.shared": 3}
