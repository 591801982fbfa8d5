"""granite-4.0-h-small's configuration and its cell,
``granite-4.0-h-small.batch_decode``: the file loads and the port's
configuration agrees with every size it states; the cell's tiny form
(the port's reduced configuration, at 3 layers with an attention layer
between two Mamba2 layers) comes out correct through the harness's own
comparison on the CPU, and not correct with each serving fault planted;
the new metrics' readers; and, on an sm_90 card, the control failing the
cell's limit at the cell's own size."""
import dataclasses
import json

import pytest
import torch

from portbench import faults, harness
from portbench.reference import decoder, hybrid_moe
from portbench.tests import tiny

CELL = "granite-4.0-h-small.batch_decode"
SEED = 2 ** 31 + 303
CPU = torch.device("cpu")
METRICS = ("moe.fill", "decode.moe_nodes", "decode_hbm_share.moe_hybrid")


def tiny_cell():
    """(cell, port arch) cut to a size the host runs in seconds;
    ``tiny.config_of`` does not carry the pattern, the multipliers or the
    expert layer, so they are added here from the port's configuration."""
    from repro_torch.configs import get_arch
    full = harness.load_cell(CELL)
    arch = dataclasses.replace(
        get_arch(full.config["port_arch"]).reduced(), n_layers=3,
        layer_types=("mamba", "attention", "mamba"))
    cfg = dict(tiny.config_of(arch), impl=full.config["impl"],
               reference=full.config["reference"], pos_kind=arch.pos_kind,
               layer_types=list(arch.layer_types),
               attention_multiplier=arch.attention_multiplier,
               embedding_multiplier=arch.embedding_multiplier,
               residual_multiplier=arch.residual_multiplier,
               logits_scaling=arch.logits_scaling,
               moe=dataclasses.asdict(arch.moe))
    traffic = dict(full.traffic, **tiny.TRAFFIC["backlog"], logits_every=2)
    return dataclasses.replace(full, config=cfg, traffic=traffic), arch


def test_the_configuration_loads_and_the_port_agrees_with_it():
    cell = harness.load_cell(CELL)
    cfg = cell.config
    assert cell.reference is hybrid_moe
    assert harness.port_arch(cfg).name == "granite-4.0-h-small"
    assert hybrid_moe.seq_multiple(cfg) == 256
    # the catalog's keys beside the port's, the same numbers
    assert (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_local_experts"], cfg["num_experts_per_tok"],
            cfg["intermediate_size"], cfg["shared_intermediate_size"],
            cfg["mamba_d_state"], cfg["mamba_n_heads"]) == (
        cfg["n_layers"], cfg["d_model"], cfg["moe"]["n_experts"],
        cfg["moe"]["top_k"], cfg["moe"]["d_expert"], cfg["d_ff"],
        cfg["ssm"]["d_state"], cfg["ssm"]["expand"] * cfg["d_model"]
        // cfg["ssm"]["head_dim"])
    assert cfg["reduced"] == ["moe.experts_held"]
    assert cfg["published"]["moe.experts_held"] == 72
    assert cfg["moe"]["experts_held"] == 9
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("key,value", [
    ("layer_types", ["attention"] * 40),
    ("attention_multiplier", 1 / 64),
    ("residual_multiplier", 1.0),
    ("logits_scaling", 1.0),
    ("embedding_multiplier", 1.0),
    ("pos_kind", "rope"),
    ("moe", "experts_held"),
    ("moe", "dropless"),
    ("ssm", "d_state")])
def test_port_arch_refuses_a_size_the_port_does_not_run(key, value):
    cfg = harness.load_cell(CELL).config
    if key in ("moe", "ssm"):
        group = dict(cfg[key])
        group[value] = (not group[value] if isinstance(group[value], bool)
                        else group[value] + 1)
        changed = dict(cfg, **{key: group})
    else:
        changed = dict(cfg, **{key: value})
    with pytest.raises(ValueError, match=key):
        harness.port_arch(changed)


@pytest.fixture
def one_thread():
    """The tiny model's hundreds of small ops a step, on one thread: on a
    host shared with other test processes, threads waiting on each other
    made a step take most of a second."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _run(fault=None, seconds=3.0):
    cell, arch = tiny_cell()
    with faults.planted(fault):
        return harness.run_cell(cell, SEED, seconds, False, CPU, arch=arch)


@pytest.mark.parametrize("fault,correct", [
    (None, True), ("token_altered", False), ("state_unchanged", False)])
def test_the_tiny_cell_is_correct_and_each_fault_breaks_it(fault, correct,
                                                          one_thread):
    run = _run(fault)
    assert run.correct is correct, run.checks
    assert set(run.checks) == {"served_gap_mean", "served_logit_err"}
    assert run.attempted > 0 and run.failed == 0
    metrics = harness.metrics_of(run)
    assert set(metrics) == {"gen_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in metrics.values())


def test_the_tiny_run_records_what_the_new_metrics_read(one_thread):
    run = _run()
    waves = [w for w in run.record["waves"] if "moe_routed" in w]
    assert waves
    cap, held, layers = 2, 2, 3          # 2 slots, dropless; 2 of 4 held
    rows = sum(len(w["decode_s"]) * layers * held * cap for w in waves)
    assert all(w["batch"] == cap for w in waves)
    routed = sum(w["moe_routed"] for w in waves)
    assert 0 < routed <= rows
    fill = harness.load_metric("moe.fill").read(run.record, None)
    assert fill == pytest.approx(100 * routed / rows)
    # no graph on the host: no kernel nodes to count
    assert harness.load_metric("decode.moe_nodes").read(run.record,
                                                        None) is None
    share = harness.load_metric("decode_hbm_share.moe_hybrid")
    assert share.read(run.record, None) > 0


@pytest.mark.parametrize("name", METRICS)
def test_each_new_metric_reads_nothing_from_an_empty_record(name):
    mod = harness.load_metric(name)
    assert mod.read({}, None) is None
    assert mod.read({"waves": []}, None) is None
    assert mod.WORKLOADS == [CELL]


def test_the_readers_count_what_they_say():
    fill = harness.load_metric("moe.fill")
    moe = {"n_experts": 72, "experts_held": 9, "dropless": True}
    waves = [{"moe_routed": 40, "batch": 4, "decode_s": [0.1] * 2},
             {"moe_routed": 32, "batch": 2, "decode_s": [0.1] * 4},
             {"batch": 4, "decode_s": [0.1] * 9}]
    rec = {"cfg": {"n_layers": 4, "moe": moe}, "waves": waves}
    rows = 4 * 9 * (4 * 2 + 2 * 4)      # layers × held × tokens, a step
    assert fill.read(rec, None) == pytest.approx(100 * 72 / rows)
    rec["cfg"]["moe"] = dict(moe, dropless=False)
    assert fill.read(rec, None) is None
    nodes = harness.load_metric("decode.moe_nodes")
    spans = {"moe.route": 100, "moe.experts": 50, "moe.shared": 7,
             "mixer.ssm": 900}
    assert nodes.read({"waves": [{"graph_span_nodes": spans}]},
                      None) == 157
    share = harness.load_metric("decode_hbm_share.moe_hybrid")
    cfg = harness.load_cell(CELL).config
    from repro_torch.configs import get_arch
    assert share.weight_params(cfg) == get_arch(cfg["port_arch"]).param_count
    # 33.70 GB of weights, 4.83 GB of SSM state read and written, K/V
    one = share.step_bytes(cfg, 32, 256)
    assert 43.7e9 < one < 43.8e9
    assert share.step_bytes(cfg, 32, 257) - one == 4 * 2 * 2 * 32 * 8 * 128
    rec = {"cfg": cfg, "waves": [{"batch": 32, "prompt_len": 256,
                                  "decode_s": [0.02, 0.02]}]}
    want = (one + share.step_bytes(cfg, 32, 257)) / (0.04 * 3.35e12)
    assert share.read(rec, None) == pytest.approx(100 * want)


def test_the_control_fails_where_the_program_passes(card):
    """The reference in TF32 in the program's place at the cell's own size
    comes out not correct, while the program's numbers of the same run
    keep to the limit."""
    cell = harness.load_cell(CELL)
    # 45 s: the first wave (a prefill, 511 steps) ends inside the window
    run = harness.run_cell(cell, 2 ** 31 + 977, 45.0, False, card,
                           control=True)
    assert not run.correct, (run.checks, run.readings)
    for key, c in run.checks.items():
        assert run.readings[f"program_{key}"] <= c["limit"], run.readings


def test_the_control_switch_is_the_decoders():
    """``serving.check`` turns the control's TF32 on with
    ``decoder.tf32`` for any reference module."""
    assert not hasattr(hybrid_moe, "tf32")
    with decoder.tf32(True):
        assert torch.backends.cuda.matmul.allow_tf32


def test_the_kept_logits_fill_the_store_then_allocate():
    """``Kept`` copies each kept step's logits into the store made at the
    first step served, warms the copy once unkept, and past
    ``RESERVED_WAVES`` waves allocates the rows it keeps."""
    from portbench.kinds import backlog_logits as bl

    class Server:
        def _wave(self, reqs):
            for step in range(4):
                self._argmax(torch.full((2, 7), 10.0 * len(self.seen)
                                        + step))
            self.seen.append(reqs)

        def _argmax(self, last):
            return last.argmax(-1)

    server = Server()
    server.seen = []
    kept = bl.Kept(every=2, vocab=5, per_wave=2)
    kept.attach(server)
    reqs = []
    for w in range(bl.RESERVED_WAVES + 2):
        reqs.append([dataclasses.make_dataclass("R", ["prompt"])(
            prompt=torch.tensor([w]))])
        server._wave(reqs[-1])
    assert kept.store.shape == (bl.RESERVED_WAVES * 2, 2, 5)
    assert kept.used == len(kept.store)
    served = kept.served([(r[0].prompt, [0]) for r in reqs])
    for w, (_, _, rows) in enumerate(served):
        assert sorted(rows) == [1, 3]
        for step, row in rows.items():
            assert torch.equal(row, torch.full((5,), 10.0 * w + step))
        in_store = rows[1].data_ptr() - kept.store.data_ptr()
        assert (0 <= in_store < kept.store.nbytes) == (
            w < bl.RESERVED_WAVES)
