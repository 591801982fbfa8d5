"""The outlier models' compiled functions in the port, on the CPU.

The reference jits eight functions on the paper's streaming loop:
k-means ``_assign`` and ``_assign_update`` (``repro/ml/kmeans.py``), the
auto-encoder's ``ae_forward``, ``ae_recon_error``, ``ae_loss`` and its
step (``repro/ml/autoencoder.py``), and the forest's ``_fit`` and
``_score`` (``repro/ml/isoforest.py``).  Their counterparts are
``repro_torch.graphs.GraphFn`` objects: one CUDA graph a key on the card,
the eager function on the host.  Here, for each of them (and for the AE
processor's two calls, ``scores_fn`` and ``AutoEncoder._update``):

* the static-program guard, the host's stand-in for "a CUDA graph can
  capture it" (``tests/test_torch_decode_static.py``'s ``SYNCS``, and
  ``bincount``, whose CUDA form reads the ids' maximum): no op that reads
  a value on the host, and two inputs of one shape dispatch the same ops
  on the same output shapes.  With ``impl="kernel"`` the CPU runs the
  kernel's plain version, which the card never captures: the guard then
  stands the plain version in for the launch, which on the card only
  allocates its outputs;
* the host path of each compiled function, and each processor method
  that calls one, is the eager function bit for bit;
* parity with the reference's jitted function on the same numpy inputs:
  k-means within ``tests/test_torch_kmeans.py``'s tolerances, the AE on
  carried weights within ``tests/test_torch_autoencoder.py``'s 1e-5 /
  5e-5, the forest's score on a forest the reference built;
* four workers in lock step through the compiled update keep one step a
  round, as the reference's do; a function keeps at most ``limit``
  graphs, and a model's compiled functions hold nothing of the model;
* the k-means kernel's two forms counted apart from a graph's kernel
  nodes by their mangled template arguments.

The captures themselves run on the card (``tests/test_torch_cuda.py -k
outlier_graph``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \\
        tests/test_torch_outlier_static.py
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.core as jcore
import repro.ml as jml
import repro.ml.autoencoder as JA
import repro.ml.isoforest as JI
import repro.ml.kmeans as JK
import repro_torch.core as tcore
import repro_torch.ml as tml
from repro_torch import graphs
from repro_torch.kernels import build
from repro_torch.kernels import kmeans as tk
from repro_torch.ml import autoencoder as TA
from repro_torch.ml import isoforest as TI
from repro_torch.ml import kmeans as TK

from test_torch_decode_static import SYNCS, _Ops

# bincount's CUDA form reads max(ids) on the host to size its output
GUARD = SYNCS | {"aten.bincount"}
PRECISIONS = ("fp32", "bf16", "int8")
IMPLS = {"kernel": "pallas", "fused": "fused", "twopass": "jnp"}
CENT_TOL = dict(rtol=1e-5, atol=1e-4)       # tests/test_torch_kmeans.py's
FWD_RTOL = 1e-5                             # test_torch_autoencoder.py's
PARAM_ATOL = 5e-5


def _points(n, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((n, 32))
            * scale).astype(np.float32)


def _same_bits(a, b):
    """Two trees of tensors with the same structure, types, shapes and
    bits (a NaN threshold equals a NaN of the same bits)."""
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
            x, y = x.view(bits), y.view(bits)
        assert torch.equal(x, y)


def _km_inputs(impl, precision, fused):
    def inputs(seed, n=600):
        x = torch.from_numpy(_points(n, seed))
        # centroids off the points: no distance at the cancellation floor
        cent = x[:25] + 0.5
        counts = torch.arange(25, dtype=torch.float32)
        return ((cent, counts, x) if fused else (cent, x),
                dict(impl=impl, precision=precision))
    return inputs


def _ae_state():
    return tml.AutoEncoder(device="cpu", seed=2).init()


def _ae_inputs(kind):
    def inputs(seed, n=600):
        st = _ae_state()
        x = torch.from_numpy(_points(n, seed))
        if kind == "step":
            return (st["params"], st["opt"], st["step"] + seed, x), {}
        if kind == "update":
            return (st["params"], st["opt"], st["step"], x), dict(epochs=2)
        return (st["params"], x), {}
    return inputs


@functools.lru_cache(maxsize=None)
def _host_forest():
    return tml.IsolationForest(n_trees=20, device="cpu").fit(
        _points(1_000, 99))


def _fit_inputs(seed, n=600):
    return ((torch.from_numpy(_points(n, seed)),),
            dict(seed=0, n_trees=20, psi=256, max_depth=8))


def _score_inputs(seed, n=600):
    st = _host_forest()
    return ((st["forest"], torch.from_numpy(_points(n, seed)), st["psi"]),
            dict(max_depth=8))


_AE = tml.AutoEncoder(device="cpu")
CASES = {
    **{f"assign_{i}_{p}": (TK.assign_fn, _km_inputs(i, p, False))
       for i in IMPLS for p in PRECISIONS},
    **{f"assign_update_{i}_{p}": (TK.assign_update_fn,
                                  _km_inputs(i, p, True))
       for i in IMPLS for p in PRECISIONS},
    "ae_forward": (TA.ae_forward_fn, _ae_inputs("forward")),
    "ae_recon_error": (TA.ae_recon_error_fn, _ae_inputs("recon")),
    "ae_loss": (TA.ae_loss_fn, _ae_inputs("loss")),
    "ae_step": (_AE._step, _ae_inputs("step")),
    "ae_scores": (TA.scores_fn, _ae_inputs("scores")),
    "ae_update": (_AE._update, _ae_inputs("update")),
    "iforest_fit": (TI.fit_fn, _fit_inputs),
    "iforest_score": (TI.score_fn, _score_inputs),
}


def _launch_stub(prep, fused):
    """What ``kernels.kmeans.launch`` does on the card besides its launch:
    allocate the outputs."""
    n, (k, f) = prep.points.shape[0], prep.centroids.shape
    ids = torch.empty(n, dtype=torch.int32)
    dmin = torch.empty(n, dtype=torch.float32)
    if not fused:
        return ids, dmin
    return ids, dmin, torch.empty((k, f)), torch.empty(k)


def _trace(fn, args, static):
    with torch.no_grad(), _Ops() as mode:
        fn.eager(*args, **static)
    return mode.ops


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_function_reads_nothing_on_the_host(name, monkeypatch):
    """Two calls of one key (other values, one shape): no op that reads a
    tensor's value on the host, and the same ops on the same output
    shapes in both, so one graph replays for every message of a
    stream."""
    fn, inputs = CASES[name]
    if "_kernel_" in name:
        monkeypatch.setattr(tk, "plain", _launch_stub)
    first, second = (_trace(fn, *inputs(seed)) for seed in (1, 2))
    synced = [op for op, _ in first + second if op in GUARD]
    assert not synced, synced
    assert first == second
    assert first


def test_guard_sees_bincount_and_one_hot():
    """The guard's premise for k-means: the plain forms the port had
    before (``bincount`` counts, an ``F.one_hot`` matrix) show host
    reads."""
    ids = torch.tensor([0, 2, 2, 1])
    for form in (lambda: torch.bincount(ids, minlength=3),
                 lambda: torch.nn.functional.one_hot(ids, 3)):
        with _Ops() as mode:
            form()
        assert any(op in GUARD for op, _ in mode.ops), mode.ops


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_function_on_the_host_is_the_eager_function(name):
    """On CPU tensors the compiled function is its eager function bit for
    bit (the forest's fit with a new generator seeded as
    ``IsolationForest.fit`` seeds it), and records no graph."""
    fn, inputs = CASES[name]
    for seed in (1, 2):
        args, static = inputs(seed)
        got = fn(*args, **static)
        if fn.seeded:
            st = dict(static)
            want = fn.fn(torch.Generator().manual_seed(st.pop("seed")),
                         *args, **st)
        else:
            want = fn.fn(*args, **static)
        _same_bits(got, want)
        _same_bits(fn.eager(*args, **static), want)
    assert fn.graphs == {} and fn.last is None


def test_processors_on_the_host_are_their_eager_paths():
    """Each model's methods through the compiled functions
    (``graph=True``, the default) and op by op (``graph=False``) on the
    same messages, bit for bit, at every k-means impl and precision."""
    msgs = [_points(800, s) for s in (3, 4)]
    for impl in IMPLS:
        for precision in PRECISIONS:
            a, b = (tml.KMeans(impl=impl, precision=precision, graph=g,
                               device="cpu") for g in (True, False))
            sa, sb = a.init(msgs[0]), b.init(msgs[0])
            for m in msgs:
                sa, ia, da = a.assign_update(sa, m)
                sb, ib, db = b.assign_update(sb, m)
                _same_bits((sa, ia, da), (sb, ib, db))
                _same_bits(a.assign(sa, m), b.assign(sb, m))
    a, b = (tml.AutoEncoder(epochs_per_batch=2, graph=g, device="cpu")
            for g in (True, False))
    sa, sb = a.init(), b.init()
    for m in msgs:
        _same_bits(a.outlier_scores(sa, m), b.outlier_scores(sb, m))
        (sa, la), (sb, lb) = a.update(sa, m), b.update(sb, m)
        assert la == lb
        _same_bits(sa, sb)
    a, b = (tml.IsolationForest(n_trees=10, graph=g, device="cpu")
            for g in (True, False))
    for m in msgs:
        fa, fb = a.fit(m), b.fit(m)
        _same_bits(fa, fb)
        _same_bits(a.outlier_scores(fa, m), b.outlier_scores(fb, m))


def test_forest_fit_is_the_fit_before_compilation():
    """``IsolationForest.fit`` through ``fit_fn`` is the forest the port
    built before it had a compiled fit: ``_fit`` on a new generator
    seeded with the model's seed."""
    pts = _points(900, 6)
    f = tml.IsolationForest(n_trees=12, seed=5, device="cpu")
    want = TI._fit(torch.Generator().manual_seed(5), torch.from_numpy(pts),
                   12, 256, f.max_depth)
    _same_bits(f.fit(pts)["forest"], want)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_kmeans_compiled_functions_match_the_reference(impl, precision):
    """``assign_fn`` and ``assign_update_fn`` against the reference's
    jitted ``_assign`` and ``_assign_update`` on the same numpy inputs
    (kernel ↔ pallas in interpret mode, fused ↔ fused, twopass ↔ jnp):
    ids and counts exact, distances and centroids within
    ``tests/test_torch_kmeans.py``'s tolerance."""
    x = _points(400, 7)
    cent = x[:25] + 0.5
    counts = np.arange(25, dtype=np.float32)
    kw = dict(impl=impl, precision=precision)
    jkw = dict(impl=IMPLS[impl], precision=precision)
    ids, dmin = TK.assign_fn(torch.from_numpy(cent), torch.from_numpy(x),
                             **kw)
    jids, jdmin = JK._assign(jnp.asarray(cent), jnp.asarray(x), **jkw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(dmin.numpy(), np.asarray(jdmin), **CENT_TOL)
    got = TK.assign_update_fn(torch.from_numpy(cent),
                              torch.from_numpy(counts),
                              torch.from_numpy(x), **kw)
    want = JK._assign_update(jnp.asarray(cent), jnp.asarray(counts),
                             jnp.asarray(x), **jkw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in ((got[0], want[0]), (got[3], want[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CENT_TOL)


def test_ae_compiled_functions_match_the_reference():
    """``ae_forward_fn``, ``ae_recon_error_fn``, ``ae_loss_fn`` and the
    compiled step against the reference's jitted functions on weights the
    reference initialised: outputs within 1e-5 relative, the step's loss
    within 1e-5 and its params within 5e-5."""
    st_j = jml.AutoEncoder().init()
    st_t = TA.load_reference_state(jax.tree.map(np.asarray, st_j), "cpu")
    x = _points(500, 8, scale=1.0)
    xt = torch.from_numpy(x)
    for fn, jfn in ((TA.ae_forward_fn, JA.ae_forward),
                    (TA.ae_recon_error_fn, JA.ae_recon_error),
                    (TA.ae_loss_fn, JA.ae_loss)):
        np.testing.assert_allclose(fn(st_t["params"], xt).numpy(),
                                   np.asarray(jfn(st_j["params"], x)),
                                   rtol=FWD_RTOL, atol=FWD_RTOL)
    ref, port = jml.AutoEncoder(), tml.AutoEncoder(device="cpu")
    jp, jo, jl = ref._step(st_j["params"], st_j["opt"], st_j["step"], x)
    tp, to, tl = port._step(st_t["params"], st_t["opt"], st_t["step"], xt)
    assert float(tl) == pytest.approx(float(jl), rel=FWD_RTOL)
    for g, w in zip(tp, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=PARAM_ATOL)
    # the processor's scores: the reference's normalisation then its error
    np.testing.assert_allclose(
        TA.scores_fn(st_t["params"], xt).numpy(),
        np.asarray(ref.outlier_scores(st_j, x)), rtol=FWD_RTOL,
        atol=FWD_RTOL)


def test_forest_score_fn_on_a_reference_forest():
    """``score_fn`` on a forest the reference built, carried across, and
    the reference's jitted ``_score`` on the same points: every tree's
    path lengths are the same bits (``tests/test_torch_isoforest.py``),
    and the scores agree within its 1e-6.  They are not the same bits:
    the mean over the trees adds in another order, and XLA's ``pow``
    rounds otherwise than torch's (each about an ulp)."""
    pts = _points(1_200, 9)
    f = jml.IsolationForest(n_trees=30)
    st = f.fit(pts)
    st_t = TI.load_reference_state(jax.tree.map(np.asarray, st), "cpu")
    x = np.concatenate([pts, _points(64, 10, scale=30.0)])
    got = TI.score_fn(st_t["forest"], torch.from_numpy(x), st_t["psi"],
                      max_depth=f.max_depth).numpy()
    want = np.asarray(JI._score(st["forest"], jnp.asarray(x), st["psi"],
                                f.max_depth))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_workers_through_the_compiled_update_lose_updates_as_the_reference(
        n_workers):
    """``tests/test_torch_autoencoder.py``'s lock-step test, with every
    port worker's update counted through the compiled ``_update``:
    ``n_workers`` workers publish a version a message but keep one step a
    round, as the reference's do."""
    rounds = 3
    pts = [_points(200, 40 + i) for i in range(rounds * n_workers)]
    steps, calls = {}, []
    for name, core, ae in (("ref", jcore, jml.AutoEncoder()),
                           ("port", tcore, tml.AutoEncoder(device="cpu"))):
        ps = core.ParameterService()
        ps.publish("ae", ae.init())
        barrier = threading.Barrier(n_workers, timeout=60)
        update = ae.update
        if name == "port":
            compiled = ae._update

            def counted(*args, compiled=compiled, **kw):
                calls.append(1)
                return compiled(*args, **kw)

            ae._update = counted

        def lock_step(state, points, update=update, barrier=barrier):
            barrier.wait()
            return update(state, points)

        ae.update = lock_step
        proc = ae.make_processor(ps, "ae")

        def worker(w, proc=proc):
            for r in range(rounds):
                proc(None, data=pts[r * n_workers + w])

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        version, tree = ps.fetch("ae")
        assert version == 1 + rounds * n_workers
        steps[name] = int(tree["step"])
    assert len(calls) == rounds * n_workers
    assert steps["port"] == steps["ref"] == rounds


def test_graph_fn_keeps_its_most_recently_used_graphs():
    """A compiled function keeps ``limit`` graphs: one more drops the
    least recently used; a lookup makes a graph the most recent."""
    fn = graphs.GraphFn(TA.ae_loss, limit=3)
    for key in range(3):
        fn._make_room()
        fn.graphs[key] = object()
    assert fn._graph(0) is not None
    fn._make_room()
    fn.graphs["new"] = object()
    assert list(fn.graphs) == [2, 0, "new"]
    assert fn._graph(1) is None
    assert graphs.MAX_GRAPHS >= 2
    fn.clear()
    assert fn.graphs == {} and fn.pool is None


def test_a_model_and_its_compiled_functions_hold_no_cycle():
    """A model's compiled functions (the AE's step and update) hold its
    optimizer and nothing of the model: dropping the last reference to
    the model frees it and them at once, without the garbage collector;
    so does a graph's closure, which holds the function's ``fn``."""
    import gc
    import weakref
    ae = tml.AutoEncoder(device="cpu")
    refs = [weakref.ref(ae), weakref.ref(ae._update), weakref.ref(ae._step)]
    gc.disable()
    try:
        del ae
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_positional_arguments_must_be_tensors():
    """Static values go by keyword: a number among the positional
    arguments raises, on the host too."""
    with pytest.raises(TypeError, match="by keyword"):
        TI.score_fn(_host_forest()["forest"], torch.zeros(4, 32), 256.0,
                    max_depth=8)


def test_output_packing_round_trips():
    """The outputs a graph returns are packed into one flat buffer a
    dtype and rebuilt as views of copies of them: the same tree, types,
    shapes and values."""
    tree = {"a": torch.arange(6, dtype=torch.float32).view(2, 3),
            "b": [torch.tensor(7, dtype=torch.int32),
                  torch.tensor([True, False])],
            "c": torch.ones((), dtype=torch.float32)}
    flats, layout = graphs._pack(tree)
    assert [f.dtype for f in flats] == [torch.float32, torch.int32,
                                        torch.bool]
    _same_bits(graphs._unpack([f.clone() for f in flats], layout), tree)


def _mangled(rows, t, fused):
    return (f"_ZN12_GLOBAL__N_113assign_kernelILi{rows}E{t}Lb{int(fused)}"
            f"EEEvPKT0_PKfS5_S5_iii4PlanPiPfS8_S8_")


def test_kmeans_launches_counted_from_kernel_names():
    """The k-means kernel's two forms are one template,
    ``assign_kernel<rows, T, fused>``: ``count_launches`` tells them apart
    by the fused flag's mangled argument, for the three tiles and the
    three point types (f fp32, t the bf16 bits, a int8);
    ``reduce_partials``, the fused form's second launch, counts for
    neither, and no other counter takes them."""
    names = [_mangled(rows, t, fused) for rows in tk.TILES
             for t in "fta" for fused in (True, False)]
    names += ["_ZN12_GLOBAL__N_115reduce_partialsEPKfS1_iiiPfS2_",
              "_ZN12_GLOBAL__N_117my_assign_kernelILi128EfLb1EEEv"]
    counts = build.count_launches(names)
    assert counts[tk.LAUNCHES["kmeans_assign_update"]] == 9
    assert counts[tk.LAUNCHES["kmeans_assign"]] == 9
    assert sum(counts.values()) == 18


def test_launch_counter_tallies_each_thread():
    """``mine`` is what ``incr`` counted on the calling thread alone (a
    capture takes back its own thread's launches while other workers
    launch); ``count`` is every thread's, with what ``add`` moved."""
    c = build.LaunchCounter()
    try:
        c.incr()
        seen = []

        def other():
            for _ in range(5):
                c.incr()
            seen.append(c.mine())

        t = threading.Thread(target=other)
        t.start()
        t.join()
        c.add(-2)
        assert seen == [5] and c.mine() == 1 and c.count == 4
    finally:
        build.COUNTERS.remove(c)
