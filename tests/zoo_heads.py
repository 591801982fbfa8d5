"""The head structures of the five archs that ``chip_smoke.py`` serves at
full width since ROADMAP A11, on 2-layer configs narrow enough for the CPU.

``ArchConfig.reduced()`` gives every arch 4 query heads on 2 KV heads of
16 dims and 4 experts; :func:`head_config` puts back the full arch's head
structure (query and KV heads, head_dim, codebooks, the SSM's d_state and
head_dim, arctic's top-2 with its dense residual) and keeps d_model and
vocab narrow.  It takes ``get_arch`` so both packages build the same
config: ``head_config(repro.configs.get_arch, arch)`` and
``head_config(repro_torch.configs.get_arch, arch)``.  Imports neither
package, so the card's tests (no JAX there) share it."""
import dataclasses

ARCHS = ("mistral-nemo-12b", "nemotron-4-340b", "arctic-480b",
         "musicgen-medium", "mamba2-130m")

HEADS = {
    # GQA 32/8 at D 128: a group of 4
    "mistral-nemo-12b": dict(n_heads=8, n_kv_heads=2, d_head=128),
    # 96/8 at D 192: a group of 12
    "nemotron-4-340b": dict(n_heads=12, n_kv_heads=1, d_head=192),
    # 56/8 at D 128: a group of 7; top-2 with the dense residual
    "arctic-480b": dict(n_heads=14, n_kv_heads=2, d_head=128),
    # MHA 24/24 at D 64 over 4 codebooks
    "musicgen-medium": dict(n_heads=6, n_kv_heads=6, d_head=64),
    # SSD with d_state 128 and 64-wide heads
    "mamba2-130m": dict(),
}


def head_config(get_arch, arch: str):
    """The 2-layer, narrow config of ``arch`` with its real head
    structure, from the package whose ``get_arch`` is given."""
    full = get_arch(arch)
    cfg = full.reduced()
    kw = dict(HEADS[arch])
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, top_k=full.moe.top_k,
            dense_residual=full.moe.dense_residual)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=full.ssm.d_state,
                                        head_dim=full.ssm.head_dim)
    return dataclasses.replace(cfg, **kw)


def full_heads(get_arch, arch: str):
    """(H, Hkv, D) of the full arch: the flash kernel's shape there."""
    full = get_arch(arch)
    return full.n_heads, full.n_kv_heads, full.head_dim
