"""The benchmark's files, found by name; its names and units; its
yardstick; and what its modules import.  CPU only."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, serving
from portbench import yardstick as Y
from portbench.kinds import train_steps

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert (ROOT / "portbench" / "kinds"
            / f"{c.traffic['kind']}.py").is_file()
    harness.load_kind(c.traffic["kind"])
    harness.port_arch(c.config)
    assert c.check["limits"]
    for m in c.per_layer:
        assert hasattr(harness.load_metric(m["name"]), "read")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def _copy_bench(tmp_path) -> Path:
    """A copy of ``portbench/`` (without its tests) under ``tmp_path``."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return bench


def test_a_cell_added_as_files_is_found(tmp_path):
    bench = _copy_bench(tmp_path)
    mix = json.loads((bench / "traffic" / "decode_heavy.json").read_text())
    mix["queued"] = 8
    (bench / "traffic" / "decode_light.json").write_text(json.dumps(mix))
    (bench / "workloads" / "hymba-1.5b.decode_light.json").write_text(
        json.dumps({"config": "hymba-1.5b", "traffic": "decode_light",
                    "check": {"sample_requests": 8,
                              "limits": {"served_gap_mean": 1.0}}}))
    (bench / "metrics" / "serve.waves.py").write_text(
        'UNIT = "count"\nLAYER = "serve front end"\n'
        'MOVES = "gen_tokens_per_s"\nSOURCE = "program_counter"\n'
        'WORKLOADS = ["hymba-1.5b.decode_light"]\n\n\n'
        'def read(rec, trace):\n    return len(rec.get("waves", ()))\n')
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "hymba-1.5b.decode_light",
                              "config": "hymba-1.5b",
                              "traffic": "decode_light", "chips": 1,
                              "why": "a shorter backlog"})
    moves = next(m for m in spec["end_to_end"]
                 if m["name"] == "gen_tokens_per_s")
    moves["workloads"].append("hymba-1.5b.decode_light")
    spec["per_layer"].append({"name": "serve.waves", "unit": "count",
                              "better": "lower",
                              "source": "program_counter",
                              "layer": "serve front end",
                              "moves": "gen_tokens_per_s",
                              "workloads": ["hymba-1.5b.decode_light"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("hymba-1.5b.decode_light", bench_dir=bench)
    assert cell.traffic["queued"] == 8
    assert [m["name"] for m in cell.per_layer] == ["serve.waves"]
    assert {m["name"] for m in cell.end_to_end} == {"gen_tokens_per_s",
                                                   "setup_s"}
    reader = harness.load_metric("serve.waves", bench)
    assert reader.read({"waves": [{}, {}]}, None) == 2


TOY_SSM = '''"""A pure Mamba2 stack, a block decoder.block lacks: the
embedding, pre-norm Mamba2 blocks on the residual, the final norm and the
head tied to the embedding."""
from portbench.reference import decoder


def seq_multiple(cfg):
    return cfg["ssm"]["chunk"]


def forward(params, cfg, ids, *, cache_rows_from=None):
    if ids.shape[1] % seq_multiple(cfg):
        raise ValueError("pad the sequence to a multiple of the SSD chunk")
    eps = cfg["norm_eps"]
    x = params["embed"][ids]
    for lp in params["blocks"]:
        x = x + decoder.mamba2(lp["ssm"], decoder.rms(x, lp["ln1"], eps), cfg)
    x = decoder.rms(x, params["ln_f"], eps)
    return x @ params["embed"][:cfg["vocab_size"]].T
'''

# the port's mamba2-130m as a configuration file states it
MAMBA2 = {
    "name": "mamba2-130m", "port_arch": "mamba2-130m",
    "reference": "toy_ssm", "block": "none", "pos_kind": "none",
    "n_layers": 24, "d_model": 768, "n_heads": 0, "n_kv_heads": 0,
    "d_head": 0, "d_ff": 0, "ffn_kind": "none", "vocab_size": 50280,
    "padded_vocab_size": 50304, "rope_theta": 10000.0, "norm_eps": 1e-05,
    "sliding_window": None, "tie_embeddings": True,
    "ssm": {"d_state": 128, "d_conv": 4, "expand": 2, "head_dim": 64,
            "n_groups": 1, "chunk": 256, "dt_min": 0.001, "dt_max": 0.1},
    "impl": "kernel", "precision": {"weights": "float32", "tf32": False},
    "reduced": []}


def test_a_configuration_added_as_files_is_found_and_used(tmp_path,
                                                          monkeypatch):
    import torch
    from portbench.tests import tiny
    bench = _copy_bench(tmp_path)
    before = sorted(p for p in bench.rglob("*") if p.is_file())
    (bench / "reference" / "toy_ssm.py").write_text(TOY_SSM)
    (bench / "configs" / "mamba2-130m.json").write_text(json.dumps(MAMBA2))
    (bench / "traffic" / "chat.json").write_text(json.dumps(
        dict(tiny.TRAFFIC["backlog"], kind="backlog", trace_s=1.0)))
    name = "mamba2-130m.chat"
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(
        {"config": "mamba2-130m", "traffic": "chat",
         "check": {"sample_requests": 4,
                   "limits": {"served_gap_mean": 1e-3}}}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "mamba2-130m",
                            "source": "https://huggingface.co/state-spaces/"
                                      "mamba2-130m",
                            "file": "portbench/configs/mamba2-130m.json",
                            "reduced": [], "why": "a pure Mamba2 stack"})
    spec["workloads"].append({"name": name, "config": "mamba2-130m",
                              "traffic": "chat", "chips": 1,
                              "why": "short prompts, a pure SSM decode"})
    next(m for m in spec["end_to_end"] if m["name"] == "gen_tokens_per_s")[
        "workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    full = harness.load_cell(name, bench_dir=bench)
    assert harness.port_arch(full.config).name == "mamba2-130m"
    cell, arch = tiny.cell(name, bench)
    for module in (full.reference, cell.reference):
        assert module.__name__ == "portbench.reference.toy_ssm"
        assert Path(module.__file__) == bench / "reference" / "toy_ssm.py"
    model = cell.reference
    multiple = model.seq_multiple(cell.config)
    calls, forward = [], model.forward

    def counted(params, cfg, ids, **kw):
        calls.append(ids.shape[1])
        return forward(params, cfg, ids, **kw)
    monkeypatch.setattr(model, "forward", counted)
    run = harness.run_cell(cell, 2 ** 31 + 211, 1.5, False,
                           torch.device("cpu"), arch=arch)
    assert run.correct, run.checks
    prompt = int(next(iter(cell.traffic["prompt_len"])))
    served = prompt + cell.traffic["new_tokens"] - 1
    assert multiple == arch.ssm.chunk == 32
    assert 1 <= len(calls) <= cell.check["sample_requests"]
    assert calls == [-(-served // multiple) * multiple] * len(calls)
    for path in before:
        rel = path.relative_to(bench)
        assert path.read_bytes() == (ROOT / "portbench" / rel).read_bytes()


def test_a_missing_reference_fails_when_the_cell_loads(tmp_path):
    bench = _copy_bench(tmp_path)
    path = bench / "configs" / "internlm2-1.8b.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    reference="absent")))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    with pytest.raises(FileNotFoundError, match=r"reference/absent\.py"):
        harness.load_cell("internlm2-1.8b.train_4x1k", bench_dir=bench)


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_and_its_tiny_form_resolve_the_files_reference(cell):
    from portbench.reference import decoder
    from portbench.tests import tiny
    full = harness.load_cell(cell)
    assert full.config["reference"] == "decoder"
    assert full.reference is decoder
    small, _ = tiny.cell(cell)
    assert small.config["reference"] == full.config["reference"]
    assert small.reference is decoder


@pytest.mark.parametrize("config,multiple", [("hymba-1.5b", 256),
                                             ("internlm2-1.8b", 1)])
def test_the_decoder_pads_as_its_block_needs(config, multiple):
    from portbench.reference import decoder
    cfg = json.loads((ROOT / f"portbench/configs/{config}.json").read_text())
    assert decoder.seq_multiple(cfg) == multiple


@pytest.mark.parametrize("port,key,size", [
    ("qwen3-moe-235b-a22b", "moe", "top_k"),
    ("minicpm3-4b", "mla", "kv_lora_rank")])
def test_port_arch_checks_every_size_the_file_states(port, key, size,
                                                     monkeypatch):
    import dataclasses
    import repro_torch.configs
    from portbench.tests import tiny
    arch = repro_torch.configs.get_arch(port).reduced()
    monkeypatch.setattr(repro_torch.configs, "get_arch", lambda name: arch)
    cfg = dict(tiny.config_of(arch), pos_kind=arch.pos_kind,
               **{key: dataclasses.asdict(getattr(arch, key))})
    assert harness.port_arch(cfg) is arch
    with pytest.raises(ValueError, match=key):
        harness.port_arch(dict(cfg, **{key: dict(cfg[key], **{
            size: cfg[key][size] + 1})}))
    with pytest.raises(ValueError, match=key):
        harness.port_arch({k: v for k, v in cfg.items() if k != key})
    with pytest.raises(ValueError, match="pos_kind"):
        harness.port_arch(dict(cfg, pos_kind="mrope"))


@pytest.mark.parametrize("count,args", [
    (Y.decode_bytes, (16, 256)), (Y.prefill_flops, (1, 512)),
    (Y.train_flops, (4, 1024))])
def test_the_yardstick_raises_on_a_block_it_does_not_know(count, args):
    cfg = json.loads((ROOT / "portbench/configs/hymba-1.5b.json")
                     .read_text())
    assert count(cfg, *args) > 0
    with pytest.raises(ValueError, match="no block 'mla'"):
        count(dict(cfg, block="mla"), *args)


def test_names_units_and_lengths_keep_to_the_contract():
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_declares_what_benchmark_json_says(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    mod = harness.load_metric(name)
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.WORKLOADS) == (
        entry["unit"], entry["layer"], entry["moves"], entry["source"],
        entry["workloads"])
    # every cell it names reports the end-to-end metric it moves
    moves = next(m for m in SPEC["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in CELLS
        assert cell in moves.get("workloads", CELLS)
    assert mod.read({}, None) is None


def _run_for(cell, seed):
    c = harness.load_cell(cell)
    return harness.Run(c, seed, 50.0, False, __import__("torch").device(
        "cpu"), 0.0)


def test_served_prompts_repeat_for_a_seed_and_differ_between_seeds():
    cell = "hymba-1.5b.decode_heavy"
    a, b = _run_for(cell, 2 ** 31 + 11), _run_for(cell, 2 ** 31 + 12)
    lens = [256] * 5
    pa = serving.prompts(a.rng("prompts"), lens, 32001)
    pb = serving.prompts(b.rng("prompts"), lens, 32001)
    pa2 = serving.prompts(a.rng("prompts"), lens, 32001)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pa2))
    assert not any(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert all(len(p) == 256 for p in pa)


def test_train_batches_repeat_for_a_seed_and_differ_between_seeds():
    cell = "internlm2-1.8b.train_4x1k"
    a, b = _run_for(cell, 7), _run_for(cell, 8)
    da, db = train_steps.batches(a), train_steps.batches(b)
    assert (da(3)["tokens"] == train_steps.batches(a)(3)["tokens"]).all()
    assert not (da(3)["tokens"] == db(3)["tokens"]).all()
    assert not (da(3)["tokens"] == da(4)["tokens"]).all()
    assert (da(0)["labels"][:, :-1] == da(0)["tokens"][:, 1:]).all()


def test_flash_bounds_match_the_kernel_table():
    hymba = lambda s: (4, s, s, 25, 5, 64, True, 2048)
    for s, fp32, bf16 in ((4096, 2.4043, 0.1629), (1024, 0.2005, 0.01358)):
        assert Y.flash_bound_ms(hymba(s), "fp32")[0] == pytest.approx(
            fp32, rel=5e-4)
        assert Y.flash_bound_ms(hymba(s), "bf16")[0] == pytest.approx(
            bf16, rel=5e-4)


def test_train_flops_against_a_count_by_hand():
    cfg = json.loads((ROOT / "portbench/configs/internlm2-1.8b.json")
                     .read_text())
    # a layer: wq 2048x2048, wk and wv 2048x1024, wo 2048x2048, the
    # SwiGLU's three 2048x8192; 24 layers and the 2048x92544 head
    weights = 24 * (2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 8192) \
        + 2048 * 92544
    assert weights == 1_699_479_552
    # causal pairs of a 1,024-token row, 4 rows, 16 heads of 128, 24
    # layers: QK and PV (4 flops a pair a head dim) forward, twice back
    attention = 3 * 4 * 128 * 16 * 4 * (1024 * 1025 // 2) * 24
    assert Y.train_flops(cfg, 4, 1024) == 6 * weights * 4096 + attention
    assert Y.train_flops(cfg, 4, 1024) == 43_004_568_010_752


def test_prefill_flops_and_decode_bytes_count_what_they_say():
    cfg = json.loads((ROOT / "portbench/configs/hymba-1.5b.json")
                     .read_text())
    assert Y.attention_pairs(4, None) == 10
    assert Y.attention_pairs(6, 3) == 3 + 3 + 3 + 3 + 2 + 1
    one = Y.prefill_flops(cfg, 1, 512)
    assert Y.prefill_flops(cfg, 2, 512) == pytest.approx(2 * one)
    assert Y.prefill_flops(cfg, 1, 1024) > 2 * one
    w = Y.decode_bytes(cfg, 16, 256)
    assert Y.decode_bytes(cfg, 16, 5000) > w
    assert Y.decode_bytes(cfg, 16, 5000) == Y.decode_bytes(cfg, 16, 6000)
    assert 6.0e9 < w < 7.0e9        # the fp32 weights, about 6.1 GB


def test_union_busy_and_gaps():
    busy, gaps = Y.union_busy([(1, 3), (2, 4), (6, 7)], 0, 10)
    assert busy == 4
    assert gaps == [(7, 10), (4, 6), (0, 1)]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "portbench").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("repro_torch", "repro",
                                              "jax"), (path, name)
            if name.startswith("portbench"):
                assert name.startswith("portbench.reference"), (path, name)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        "sys.path[:0] = ['src', '.']\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        "cell, arch = tiny.cell('hymba-1.5b.decode_heavy')\n"
        "harness.run_cell(cell, 3, 1.0, False, torch.device('cpu'),"
        " arch=arch)\n"
        "assert not harness.forbidden_modules(), harness.forbidden_modules()\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout
