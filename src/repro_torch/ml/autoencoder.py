"""Auto-encoder outlier detector — the paper's heaviest workload (§III.2),
ported from ``repro.ml.autoencoder``.

"We use the Keras-based auto-encoder implementation of PyOD with four hidden
layers with a size of [64, 32, 32, 64], and thus, a total number of 11,552
parameters."

PyOD's (Keras-era) builder prepends an input-width layer and appends the
reconstruction layer, so hidden_neurons=[64,32,32,64] over 32 features
yields dense sizes [32, 64, 32, 32, 64, 32] + output(32):

    32→32 (1,056) + 32→64 (2,112) + 64→32 (2,080) + 32→32 (1,056)
    + 32→64 (2,112) + 64→32 (2,080) + 32→32 (1,056)  =  11,552  ✓

The same topology as the reference: ReLU on every layer but the last,
weights laid out ``(din, dout)`` and applied as ``h @ w + b``, MSE
reconstruction loss, the reference's AdamW formulas
(:mod:`repro_torch.optim`); the outlier score is the per-point
reconstruction error, as in PyOD.  Gradients come from autograd over the
functional forward.

State is the reference's tree, ``{"params": [{"w", "b"}, ...], "opt":
{"mu", "nu"}, "step"}``, of tensors on ``device`` (which defaults to the
CUDA card and raises without one); the parameter service publishes it as
numpy, so a state either package published loads in the other
(:func:`load_reference_state`).  ``jax.random`` streams cannot be matched:
``init`` draws He-normal weights from a ``torch.Generator`` seeded by
``seed``, and parity with the reference starts from carried-across
weights.

The reference jits ``ae_forward``, ``ae_recon_error``, ``ae_loss`` and the
step; their compiled counterparts are :data:`ae_forward_fn`,
:data:`ae_recon_error_fn`, :data:`ae_loss_fn` and ``AutoEncoder._step``
(:class:`repro_torch.graphs.GraphFn`: one CUDA graph a key on the card,
the eager function on the CPU).  The processor's two methods are one
compiled call each, with the normalisation inside: ``outlier_scores``
(:data:`scores_fn`) and ``update`` (``AutoEncoder._update``: the
``epochs_per_batch`` steps, autograd's backward and AdamW in one graph);
``graph=False`` runs them op by op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.graphs import GraphFn
from repro_torch.ml.kmeans import resolve_device
# either package's published {"params", "opt", "step"} (numpy) as tensors
from repro_torch.ml.kmeans import tree_to_device as load_reference_state
from repro_torch.optim import make_optimizer


def _layer_sizes(n_features: int, hidden: Tuple[int, ...]):
    """PyOD topology (see module doc): input F, dense widths
    [F, *hidden, F], then the reconstruction output F — seven dense layers
    for hidden=(64,32,32,64), 11,552 params at F=32."""
    return [n_features, n_features, *hidden, n_features, n_features]
    # sizes[0] is the input width; the rest are layer output widths.


def ae_init(generator: torch.Generator, n_features: int = 32,
            hidden: Tuple[int, ...] = (64, 32, 32, 64)):
    """He-normal weights and zero biases on ``generator``'s device."""
    sizes = _layer_sizes(n_features, hidden)
    dev = generator.device
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator, device=dev,
                        dtype=torch.float32) * float(np.sqrt(2.0 / din))
        params.append({"w": w,
                       "b": torch.zeros((dout,), dtype=torch.float32,
                                        device=dev)})
    return params


def ae_param_count(params) -> int:
    return sum(int(np.prod(p["w"].shape)) + int(p["b"].shape[0])
               for p in params)


def ae_forward(params, x):
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def ae_recon_error(params, x):
    """Per-point L2 reconstruction error — the PyOD outlier score."""
    r = ae_forward(params, x)
    return torch.sqrt(torch.sum((r - x) ** 2, dim=-1))


def ae_loss(params, x):
    r = ae_forward(params, x)
    return torch.mean((r - x) ** 2)


def _norm(x):
    """Each feature to zero mean and unit population std (ddof 0), 1e-6
    added outside it."""
    mu = x.mean(0, keepdim=True)
    sd = x.std(0, keepdim=True, correction=0) + 1e-6
    return (x - mu) / sd


def _scores(params, points):
    """The outlier scores of a message: its normalised points'
    reconstruction errors."""
    return ae_recon_error(params, _norm(points))


def _make_step(opt):
    """The train step, ``step(params, opt_state, stepno, x) -> (params,
    opt_state, loss after the step)``: autograd's gradients of
    :func:`ae_loss`, then ``opt``'s update.  It holds ``opt`` alone."""
    def step(params, opt_state, stepno, x):
        leaves, spec = pytree.tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = ae_loss(pytree.tree_unflatten(live, spec), x)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            updates, new_opt = opt.update(
                pytree.tree_unflatten(list(grads), spec), opt_state,
                params, stepno)
            new_params = pytree.tree_map(lambda p, u: p + u, params,
                                         updates)
            return new_params, new_opt, ae_loss(new_params, x)
    return step


def _make_update(step):
    """``update(params, opt_state, stepno, points, *, epochs) -> (params,
    opt_state, stepno, loss)``: ``epochs`` steps on the normalised
    points, the step count a device tensor throughout."""
    def update(params, opt_state, stepno, points, *, epochs: int):
        x = _norm(points)
        loss = None
        for _ in range(epochs):
            params, opt_state, loss = step(params, opt_state, stepno, x)
            stepno = stepno + 1
        return params, opt_state, stepno, loss
    return update


# the compiled counterparts of the reference's jitted functions, and the
# processor's scoring call
ae_forward_fn = GraphFn(ae_forward)
ae_recon_error_fn = GraphFn(ae_recon_error)
ae_loss_fn = GraphFn(ae_loss)
scores_fn = GraphFn(_scores)


@dataclass
class AutoEncoder:
    n_features: int = 32
    hidden: Tuple[int, ...] = (64, 32, 32, 64)
    lr: float = 1e-3
    epochs_per_batch: int = 1
    seed: int = 0
    device: Optional[torch.device] = None
    graph: bool = True              # the compiled functions (False: eager)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        lr = self.lr                    # a constant of the step, as jit's
        self._opt = make_optimizer("adamw", lambda s: lr, weight_decay=0.0)
        step = _make_step(self._opt)
        # the compiled step, and the processor's update around it
        self._step = GraphFn(step)
        self._update = GraphFn(_make_update(step))

    def init(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = ae_init(gen, self.n_features, self.hidden)
        return {"params": params, "opt": self._opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def _compiled(self, fn: GraphFn):
        return fn if self.graph else fn.eager

    def update(self, state, points):
        """``epochs_per_batch`` steps on the message, one compiled call;
        the loss after the last step is read on the host."""
        params, opt, stepno, loss = self._compiled(self._update)(
            state["params"], state["opt"], state["step"],
            self._points(points), epochs=self.epochs_per_batch)
        return {"params": params, "opt": opt, "step": stepno}, float(loss)

    @torch.no_grad()
    def outlier_scores(self, state, points) -> torch.Tensor:
        return self._compiled(scores_fn)(state["params"],
                                         self._points(points))

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32,
                               device=self.device)

    def _norm(self, points) -> torch.Tensor:
        return _norm(self._points(points))

    def make_processor(self, param_service=None, model_name: str = "ae",
                       train: bool = True):
        """FaaS ``process_cloud`` handler: score with the current state,
        then (``train``) take ``epochs_per_batch`` steps on the message and
        publish; the threshold is mean + 3·std of the scores."""
        holder = {"state": None, "version": 0}

        def process_cloud(context, data=None):
            pts = np.asarray(data, np.float64)
            if holder["state"] is None:
                if (param_service is not None
                        and model_name in param_service.names()):
                    v, tree = param_service.fetch(model_name)
                    holder["state"] = load_reference_state(tree,
                                                           self.device)
                    holder["version"] = v
                else:
                    holder["state"] = self.init()
            scores = self.outlier_scores(holder["state"], pts)
            if train:
                holder["state"], loss = self.update(holder["state"], pts)
                if param_service is not None:
                    holder["version"] = param_service.publish(
                        model_name, holder["state"])
            s = scores.cpu().numpy()
            thresh = s.mean() + 3.0 * s.std()
            return {"n_outliers": int((s > thresh).sum()),
                    "mean_score": float(s.mean())}

        return process_cloud
