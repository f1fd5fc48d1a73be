"""DeepLearning — the multilayer perceptron, trained by minibatch steps.

Reference: h2o3_tpu/models/deeplearning.py (hex/deeplearning/
DeepLearning.java, Neurons.java, DeepLearningModelInfo): Rectifier, Tanh
and Maxout layers with input and hidden dropout, the UniformAdaptive
initializer, ADADELTA (rho, epsilon) or momentum SGD (Nesterov, the rate
annealing and the momentum ramp), L1/L2 on the weights, the softmax or
quadratic loss, the autoencoder, early stopping on the full-data loss,
``checkpoint=`` continuation and n-fold CV (``ml/cv.py``, on subset
frames). The design is ``frame/datainfo.py``'s dense float32 matrix on
the training frame's device.

The reference compiles a chunk of steps into one scan. Here a chunk is a
host loop of plain torch ops on the frame's device: a step slices a
contiguous batch of the design, takes the loss's gradient with
``torch.autograd.grad`` and updates the weights in place with the
``torch._foreach_*`` ops. Nothing in a chunk waits for the device: the
batch offsets are host integers, and the rate and momentum of every step
are host float32 values, computed as the reference's compiled step
computes them (``Schedule``). Early stopping reads the full-data loss
once every ``score_stride`` steps.

Random draws are the port's own, from explicit generators: the initial
weights from a CPU ``torch.Generator`` (the same seed gives the same
weights on every device), the dropout masks from one on the frame's
device. ``init_params`` and ``draw_masks`` are separate from their use,
so a test can feed in the reference's ``jax.random`` draws.

Precision: float32 products run with TF32 off (``ops/gram.exact_f32``).
From a batch of 16,384 rows a training step takes its products in bf16
with float32 sums, as the reference's does: bf16 operands, a float32
result, and gradients that JAX's transpose of that product gives (the
float32 cotangent times the bf16 operand, summed in float32, then
rounded to bf16). ``bf16_route`` picks how the forward product runs,
once a fit (``StepConfig.bf16``).

Data-parallel fit: on a frame partitioned over a sharded mesh every rank
builds its own rows' design (the means and sigmas all the rows', so its
rows are one device's) and takes the same steps. A step's batch is the
one-device slice ``[start, start + batch)`` of the global rows, in the
one-device shape: a rank holding all its rows takes the slice itself;
another puts the rows it holds in place and zeros (weight 0)
elsewhere, and one holding none of them computes no data term. The
batch's weight sum comes from every rank's copy of the global weights,
the dropout masks are drawn for the whole batch on every rank, the L1/L2
term is added on rank 0 alone, and the gradients are all-reduced in one
collective. A batch on one rank is then one device's step bit for bit
(its gradient plus the others' exact zeros; with both L1 and L2 on,
rank 0's two penalty terms may be summed before the data term), and a
batch across two differs only in the order of its sums. Early stopping
reads the all-reduced full-data loss; the training metrics are
all-reduced. On one: the autoencoder raises (ROADMAP A #12′), as do CV
and checkpoint. Not ported: the in-fit checkpointer ``core/recovery``
(A #13). Scoring runs ``_serve_input`` /
``_serve_dev`` (fixed row tiles) / ``_serve_finish``, the halves the
serving engine runs too. The reference's one-slot design memo is not
kept: the fit hands its design to the training metrics instead.
``export_weights_and_biases`` stores each layer's weights and biases as
frames in the DKV.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h2o3_tpu_torch.core.job import job_update
from h2o3_tpu_torch.frame.datainfo import build_datainfo, stats_of
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (MESH_TODO, EarlyStopper, Model,
                                         ModelBuilder, ModelCategory,
                                         adapt_domain, checkpoint_error,
                                         infer_category, masked_weights,
                                         resolve_checkpoint_model,
                                         score_tiles,
                                         validate_checkpoint_params)
from h2o3_tpu_torch.ops.gram import exact_f32
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.map_reduce import all_reduce_flat
from h2o3_tpu_torch.parallel.mesh import Mesh, fetch_global, fetch_replicated

AUTOENCODER = "AutoEncoder"
BF16_MIN_BATCH = 16384   # a training step's products run in bf16 from here
DEFAULT_SEED = 0xD1      # the reference's seed when ``seed`` < 0
CHECKPOINT_FIXED = ("activation", "standardize", "adaptive_rate",
                    "use_all_factor_levels", "autoencoder")

Net = List[Dict[str, torch.Tensor]]


def parse_activation(name: str) -> Tuple[str, bool]:
    """("rectifier" | "tanh" | "maxout", with dropout) from an h2o
    activation name such as ``RectifierWithDropout``; any other name
    trains as the rectifier, as in the reference."""
    n = name.lower().replace("withdropout", "").replace("with_dropout", "")
    return n, "dropout" in name.lower()


def layer_shapes(sizes: Sequence[int], maxout: bool) -> List[Tuple[int, int]]:
    """[fan_in, fan_out] of each layer's W: a Maxout hidden layer has two
    units a neuron."""
    return [(sizes[i], sizes[i + 1] * (2 if maxout and i < len(sizes) - 2
                                       else 1))
            for i in range(len(sizes) - 1)]


def init_params(gen: torch.Generator, sizes: Sequence[int], maxout: bool,
                device) -> Net:
    """UniformAdaptive initial weights, U(±sqrt(6 / (fan_in + fan_out)))
    with fan_out the layer's neuron count, and zero biases (reference
    DeepLearningModelInfo.randomizeWeights), drawn from the CPU
    generator ``gen`` and moved to ``device``."""
    net = []
    for i, (fin, fout) in enumerate(layer_shapes(sizes, maxout)):
        lim = float(np.sqrt(6.0 / (sizes[i] + sizes[i + 1])))
        W = torch.empty((fin, fout), dtype=torch.float32).uniform_(
            -lim, lim, generator=gen)
        net.append({"W": W.to(device),
                    "b": torch.zeros((fout,), dtype=torch.float32,
                                     device=device)})
    return net


def draw_masks(gen: torch.Generator, rows: int, widths: Sequence[int],
               input_dropout: float, hidden_dropout: Sequence[float],
               device) -> List[Optional[torch.Tensor]]:
    """One step's dropout keep masks (float32 0/1): the input's [rows,
    widths[0]] and each hidden layer's [rows, widths[i + 1]] after its
    activation; None where the ratio is 0."""
    ratios = [input_dropout] + list(hidden_dropout)
    return [torch.empty((rows, wd), dtype=torch.float32,
                        device=device).bernoulli_(1.0 - r, generator=gen)
            if r > 0 else None for wd, r in zip(widths, ratios)]


# ---- the bf16 product -----------------------------------------------------
def bf16_route(device: torch.device) -> str:
    """How a bf16 product runs on ``device``: ``mm_out_dtype`` (one
    bf16 GEMM with a float32 result, ``torch.mm(..., out_dtype=)``) where
    torch has that kernel for the device, else ``upcast`` (the bf16
    values as float32 operands of a float32 product: the same exact
    products, float32 sums)."""
    key = "CUDA" if device.type == "cuda" else "CPU"
    return ("mm_out_dtype" if torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::mm.dtype", key) else "upcast")


class _Bf16Product(torch.autograd.Function):
    """``a @ b`` with bf16 operands and a float32 result by ``route``
    (``bf16_route``), and the gradients of the reference's
    ``jax.lax.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=float32)``: the float32 cotangent times the
    other bf16 operand in float32, rounded to bf16 (the operand's dtype)
    and back."""

    @staticmethod
    def forward(ctx, a, b, route):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        if route == "mm_out_dtype":
            return torch.mm(a16, b16, out_dtype=torch.float32)
        return a16.float() @ b16.float()

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b16.float().T).to(torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            gb = (a16.float().T @ g).to(torch.bfloat16).float()
        return ga, gb, None


# ---- fprop, the loss --------------------------------------------------------
def forward(net: Net, X: torch.Tensor, act: str, *,
            masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
            input_dropout: float = 0.0, hidden_dropout: Sequence[float] = (),
            bf16: Optional[str] = None,
            record: Optional[list] = None) -> torch.Tensor:
    """fprop (Neurons.java): the last layer's linear output. ``masks``
    (``draw_masks``) apply dropout as ``h * keep / (1 - ratio)``;
    ``bf16`` is the route of bf16 products (``bf16_route``), None for
    float32 ones. ``record`` (a list) receives each hidden layer's
    pre-activation."""
    h = X
    if masks is not None and masks[0] is not None:
        h = h * masks[0] / (1 - input_dropout)
    L = len(net)
    for i, layer in enumerate(net):
        if bf16:
            z = _Bf16Product.apply(h, layer["W"], bf16) + layer["b"]
        else:
            z = torch.addmm(layer["b"], h, layer["W"])
        if i == L - 1:
            return z
        if record is not None:
            record.append(z)
        if act == "maxout":
            # amax splits a tie's gradient between the tied units, as
            # JAX's reduce-max does
            z = z.reshape(z.shape[0], -1, 2).amax(dim=2)
        elif act == "tanh":
            z = torch.tanh(z)
        else:
            z = torch.relu(z)
        if masks is not None and masks[i + 1] is not None:
            z = z * masks[i + 1] / (1 - hidden_dropout[i])
        h = z
    return h


def penalty(net: Net, l1: float, l2: float):
    """L1/L2 on the weights W (never the biases)."""
    return sum(l2 * (p["W"] ** 2).sum() + l1 * p["W"].abs().sum()
               for p in net)


def loss(net: Net, X, y, w, act: str, category: str, *, l1: float = 0.0,
         l2: float = 0.0, masks=None, input_dropout: float = 0.0,
         hidden_dropout: Sequence[float] = (), bf16: Optional[str] = None,
         wsum=None):
    """The minibatch objective: the weighted softmax NLL (``category``
    "softmax") or quadratic loss over the output width ("mse"), over
    sum(w) (or ``wsum``: the whole batch's, of a rank holding part of
    it), plus L1/L2 on the weights W (never the biases)."""
    out = forward(net, X, act, masks=masks, input_dropout=input_dropout,
                  hidden_dropout=hidden_dropout, bf16=bf16)
    if category == "softmax":
        nll = F.nll_loss(torch.log_softmax(out, dim=1), y, reduction="none")
        data = (w * nll).sum()
    else:
        err = out - (y if out.dim() == y.dim() else y[:, None])
        data = 0.5 * (w[:, None] * err * err).sum() / max(out.shape[1], 1)
    total = data / torch.clamp_min(w.sum() if wsum is None else wsum, 1e-12)
    if l1 or l2:
        total = total + penalty(net, l1, l2)
    return total


# ---- the schedules ----------------------------------------------------------
def fma_f32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add."""
    a64, b64, c64 = (np.asarray(v, np.float32).astype(np.float64)
                     for v in np.broadcast_arrays(a, b, c))
    p = a64 * b64                      # exact: 24-bit by 24-bit mantissas
    s = p + c64
    v = s - p
    err = (p - (s - v)) + (c64 - v)    # s + err == p + c exactly
    out = s.astype(np.float32)
    for i in zip(*np.nonzero(err)):    # s was rounded: round p + c once
        out[i] = np.float32(float(Fraction(float(p[i]))
                                  + Fraction(float(c64[i]))))
    return out


class Schedule(NamedTuple):
    """The rate and momentum schedules and the batch. ``lr_mu`` gives
    each step's float32 values as the reference's compiled step computes
    them: XLA folds the constant factors (rate_annealing · batch, and
    batch / momentum_ramp as batch · (1 / momentum_ramp)) and fuses each
    remaining multiply and add into one rounding."""
    rate: float
    rate_annealing: float
    momentum_start: float
    momentum_stable: float
    momentum_ramp: float
    batch: int

    def lr_mu(self, step0: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        f32 = np.float32
        step = f32(step0) + np.arange(k, dtype=f32)
        lr = f32(self.rate) / fma_f32(
            step, f32(f32(self.rate_annealing) * f32(self.batch)), f32(1.0))
        per = f32(f32(self.batch)
                  * (f32(1.0) / f32(max(self.momentum_ramp, 1.0))))
        ramp = np.minimum(f32(1.0), step * per)
        mu = fma_f32(f32(self.momentum_stable - self.momentum_start), ramp,
                     f32(self.momentum_start))
        return lr, mu


class StepConfig(NamedTuple):
    act: str
    category: str                # "softmax" or "mse"
    input_dropout: float
    hidden_dropout: Tuple[float, ...]
    l1: float
    l2: float
    adaptive: bool               # ADADELTA, else momentum SGD
    rho: float
    epsilon: float
    nesterov: bool
    bf16: Optional[str]          # the bf16 products' route, None: float32

    @property
    def dropout(self) -> bool:
        return self.input_dropout > 0 or any(r > 0
                                             for r in self.hidden_dropout)


def batch_size(n: int, N: int, mini_batch_size: int) -> int:
    """The reference's minibatch rule: with ``mini_batch_size`` <= 1,
    n // 64 rows between 256 and 16,384 (and at most the N design rows),
    at most max(32, n // 16) so a small fit takes ~16 steps an epoch,
    floored to a power of two."""
    batch = int(mini_batch_size)
    if batch <= 1:
        batch = min(16384, max(256, n // 64), N)
        batch = min(batch, max(32, n // 16))
        batch = 1 << (batch.bit_length() - 1)
    return batch


def batch_start(step: int, batch: int, n: int, N: int) -> int:
    """The first design row of global step ``step``'s batch: contiguous
    cyclic batches over the ``n`` rows, the start clamped so the batch
    fits in the ``N`` design rows (as the reference's ``dynamic_slice``
    clamps it)."""
    return min((step * batch) % max(n, 1), N - batch)


def sample_rows(seed: int, nrows: int, nsample: int) -> np.ndarray:
    """The rows a metric subsample scores (the reference's
    ``score_training_samples`` draw): unique draws of a RandomState."""
    rs = np.random.RandomState(seed)
    return np.unique(rs.randint(0, nrows, 2 * nsample))[:nsample]


def init_opt_state(net: Net, adaptive: bool, momentum_start: float):
    """ADADELTA's accumulators (eg2, ex2) or the momentum velocity v and
    its momentum, for each layer's W and b."""
    if adaptive:
        return [{k: {"eg2": torch.zeros_like(l[k]),
                     "ex2": torch.zeros_like(l[k])} for k in ("W", "b")}
                for l in net]
    return [{k: {"v": torch.zeros_like(l[k]),
                 "mu": np.float32(momentum_start)} for k in ("W", "b")}
            for l in net]


def _slots(opt, name: str) -> List[torch.Tensor]:
    return [s[k][name] for s in opt for k in ("W", "b")]


def _update(params, grads, opt, cfg: StepConfig, lr, mu) -> None:
    """One optimizer step over every W and b, in place."""
    if cfg.adaptive:
        eg2, ex2 = _slots(opt, "eg2"), _slots(opt, "ex2")
        rho, keep = cfg.rho, 1 - cfg.rho
        torch._foreach_mul_(eg2, rho)
        torch._foreach_addcmul_(eg2, grads, grads, value=keep)
        dx = torch._foreach_add(ex2, cfg.epsilon)
        torch._foreach_sqrt_(dx)
        torch._foreach_neg_(dx)
        den = torch._foreach_add(eg2, cfg.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(dx, den)
        torch._foreach_mul_(dx, grads)
        torch._foreach_mul_(ex2, rho)
        torch._foreach_addcmul_(ex2, dx, dx, value=keep)
        torch._foreach_add_(params, dx)
        return
    v = _slots(opt, "v")
    torch._foreach_mul_(v, mu)
    torch._foreach_add_(v, grads, alpha=-lr)
    if cfg.nesterov:
        torch._foreach_add_(params, v, alpha=mu)
        torch._foreach_add_(params, grads, alpha=-lr)
    else:
        torch._foreach_add_(params, v)
    for s in opt:
        for k in ("W", "b"):
            s[k]["mu"] = np.float32(mu)


class Shard(NamedTuple):
    """A rank's place in the global rows of a data-parallel fit: its
    logical rows are global rows ``[lo, lo + rows)`` (local rows
    ``[0, rows)``), its padded rows end at global row ``hi``; ``N`` is
    one device's padded row count and ``w_all`` every row's weight, laid
    out as on one device (each batch's weight sum)."""
    mesh: Mesh
    lo: int
    rows: int
    hi: int
    N: int
    w_all: torch.Tensor


def _shard_batch(shard: Shard, X, y, w, lo: int, batch: int, n: int):
    """(X, y, w) of global batch ``[lo, lo + batch)`` in one device's
    shape on this rank: the rank's own rows where it holds every logical
    row of the batch, else its held rows in place and zeros elsewhere;
    None where it holds none of them."""
    a, b = max(lo, shard.lo), min(lo + batch, n, shard.lo + shard.rows)
    if b <= a:
        return None
    if a == lo and b == min(lo + batch, n) and lo + batch <= shard.hi:
        s = lo - shard.lo
        return X[s:s + batch], y[s:s + batch], w[s:s + batch]
    out = []
    for t in (X, y, w):
        z = t.new_zeros((batch,) + tuple(t.shape[1:]))
        z[a - lo:b - lo] = t[a - shard.lo:b - shard.lo]
        out.append(z)
    return tuple(out)


def train_steps(net: Net, opt, X, y, w, gen: Optional[torch.Generator],
                cfg: StepConfig, sched: Schedule, step0: int, k: int,
                n: int, shard: Optional[Shard] = None) -> None:
    """``k`` minibatch steps from global step ``step0``, in place, each
    on the rows from ``batch_start``; with ``shard``, this rank's part of
    a data-parallel step (module docstring)."""
    batch = sched.batch
    N = X.shape[0] if shard is None else shard.N
    lrs, mus = sched.lr_mu(step0, k)
    params = [l[key] for l in net for key in ("W", "b")]
    widths = [X.shape[1]] + [l["W"].shape[1] // (2 if cfg.act == "maxout"
                                                 else 1) for l in net[:-1]]
    kw = dict(masks=None, input_dropout=cfg.input_dropout,
              hidden_dropout=cfg.hidden_dropout, bf16=cfg.bf16)
    for i in range(k):
        lo = batch_start(step0 + i, batch, n, N)
        kw["masks"] = (draw_masks(gen, batch, widths, cfg.input_dropout,
                                  cfg.hidden_dropout, X.device)
                       if cfg.dropout else None)
        with torch.enable_grad():
            if shard is None:
                value = loss(net, X[lo:lo + batch], y[lo:lo + batch],
                             w[lo:lo + batch], cfg.act, cfg.category,
                             l1=cfg.l1, l2=cfg.l2, **kw)
                grads = torch.autograd.grad(value, params)
            else:
                grads = _shard_grads(net, params, shard, X, y, w, lo, batch,
                                     n, cfg, kw)
        with torch.no_grad():
            _update(params, list(grads), opt, cfg, float(lrs[i]),
                    float(mus[i]))


def _shard_grads(net, params, shard: Shard, X, y, w, lo: int, batch: int,
                 n: int, cfg: StepConfig, kw):
    """This rank's gradient of global batch ``[lo, lo + batch)``, summed
    over the ranks: its rows' data term over the whole batch's weight,
    plus the L1/L2 term on rank 0."""
    part = _shard_batch(shard, X, y, w, lo, batch, n)
    lead = shard.mesh.rank == 0 and (cfg.l1 or cfg.l2)
    if part is None and not lead:
        grads = [torch.zeros_like(p) for p in params]
    else:
        if part is None:
            value = penalty(net, cfg.l1, cfg.l2)
        else:
            wsum = shard.w_all[lo:lo + batch].sum()
            value = loss(net, *part, cfg.act, cfg.category,
                         l1=cfg.l1 if lead else 0.0,
                         l2=cfg.l2 if lead else 0.0, wsum=wsum, **kw)
        grads = torch.autograd.grad(value, params)
    return all_reduce_flat(grads, shard.mesh)


def full_loss(net: Net, t, cfg: StepConfig) -> float:
    """The objective over all the training rows (early stopping's
    reading) of a fit's state ``t`` (``Training``): on a sharded mesh its
    data term summed over the ranks, over all the rows' weight."""
    if t.shard is None:
        return float(loss(net, t.X, t.y, t.w, cfg.act, cfg.category))
    mesh = t.shard.mesh
    data = loss(net, t.X, t.y, t.w, cfg.act, cfg.category,
                wsum=torch.ones((), device=t.X.device))
    data, wsum = all_reduce_flat((data, t.w.sum()), mesh)
    return float(data / torch.clamp_min(wsum, 1e-12))


# ---- the model --------------------------------------------------------------
class DeepLearningModel(Model):
    algo = "deeplearning"

    def __init__(self, params, output, net: Net, di_stats: dict,
                 features: List[str], act: str, standardize: bool,
                 resp_stats: Optional[Tuple[float, float]] = None):
        super().__init__(params, output)
        self.net = net
        self.di_stats = di_stats
        self.features = features
        self.act = act
        self.standardize = standardize
        self.resp_stats = resp_stats   # (mean, sigma) of a regression target
        self._opt_state = None         # checkpoint= continuation state
        self._steps_trained = 0
        self._gen_state = None         # (device type, generator state bytes)

    def _design(self, frame: Frame) -> torch.Tensor:
        return build_datainfo(
            frame, self.features, standardize=self.standardize,
            use_all_factor_levels=bool(
                self.params.get("use_all_factor_levels")),
            stats_override=self.di_stats).X

    def _net_on(self, device) -> Net:
        return [{k: v.detach().to(device) for k, v in l.items()}
                for l in self.net]

    def _raw_out(self, X: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), exact_f32():
            return forward(self._net_on(X.device), X, self.act)

    def _serve_input(self, frame: Frame) -> torch.Tensor:
        """The design matrix: the device input of ``_serve_dev`` (the
        serving engine's prep too)."""
        return self._design(frame)

    def _serve_dev(self, X: torch.Tensor) -> torch.Tensor:
        """The device half of scoring, shared by ``predict`` and the
        serving engine (an autoencoder scores apart): class probabilities
        [N, K] or the standardized response [N, 1], in ``score_tiles``'
        fixed tiles, float32 products (no TF32)."""
        net = self._net_on(X.device)
        classes = self.output["category"] in (ModelCategory.BINOMIAL,
                                              ModelCategory.MULTINOMIAL)

        def tile(Xt):
            out = forward(net, Xt, self.act)
            return torch.softmax(out, dim=1) if classes else out
        with torch.no_grad(), exact_f32():
            return score_tiles(tile, X)

    def _serve_finish(self, fetched: np.ndarray, n: int
                      ) -> Dict[str, np.ndarray]:
        """The host half of scoring: the prediction columns of the first
        ``n`` rows of ``_serve_dev``'s fetched output (a regression
        de-standardized on the host in float32, as the reference does)."""
        cat = self.output["category"]
        p = fetched[:n]
        if cat == ModelCategory.BINOMIAL:
            t = self.output.get("default_threshold", 0.5)
            return {"predict": (p[:, 1] >= t).astype(np.int32),
                    "p0": p[:, 0], "p1": p[:, 1]}
        if cat == ModelCategory.MULTINOMIAL:
            cols = {"predict": p.argmax(axis=1).astype(np.int32)}
            for k in range(p.shape[1]):
                cols[f"p{k}"] = p[:, k]
            return cols
        mu, sd = self.resp_stats
        return {"predict": p[:, 0] * sd + mu}

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._scores(frame, lambda t: fetch_replicated(t, frame.mesh),
                            frame.nrows)

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._scores(frame, fetch, frame.local_nrows)

    def _scores(self, frame: Frame, get, n: int) -> Dict[str, np.ndarray]:
        """The prediction columns of the first ``n`` rows ``get`` (a
        device → host copy) returns."""
        X = self._design(frame)
        if self.params.get("autoencoder"):
            out = self._raw_out(X)
            mse = ((out - X) ** 2).mean(dim=1)
            return {"reconstruction_error": get(mse)[:n]}
        return self._serve_finish(get(self._serve_dev(X)), n)

    def anomaly(self, frame: Frame) -> Frame:
        """Per-row reconstruction MSE of an autoencoder (reference
        DeepLearningModel.scoreAutoEncoder)."""
        if not self.params.get("autoencoder"):
            raise ValueError("anomaly() needs an autoencoder model")
        return Frame.from_numpy(self._score_raw(frame), device=frame.device)

    def model_performance(self, frame: Frame, mask_weights=None):
        """Metrics on ``frame``; ``mask_weights`` ([nrows_padded] host
        floats) restricts them to a row subsample (the training metrics
        score ``score_training_samples`` rows). The weights column does
        not weigh them, as in the reference."""
        return self._performance(frame, self._design(frame), mask_weights)

    def _performance(self, frame: Frame, X: torch.Tensor, mask_weights):
        y = self.output["response"]
        mesh = frame.mesh
        w = masked_weights(frame.valid_weights(), mask_weights)
        out = self._raw_out(X)
        if self.params.get("autoencoder"):
            err = ((out - X) ** 2).mean(dim=1)
            se, sw = all_reduce_flat(((w * err).sum(), w.sum()), mesh)
            mse = float(se / torch.clamp_min(sw, 1e-12))
            return mm.ModelMetrics(AUTOENCODER, int(sw), mse)
        cat = self.output["category"]
        if cat in (ModelCategory.BINOMIAL, ModelCategory.MULTINOMIAL):
            yv = frame.local_rows(adapt_domain(frame.col(y),
                                               self.output["domain"]), -1)
            w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(
                w.device)
            yt = torch.from_numpy(np.maximum(yv, 0)).to(w.device)
            p = torch.softmax(out, dim=1)
            if cat == ModelCategory.BINOMIAL:
                return mm.binomial_metrics(p[:, 1], yt.to(torch.float32), w,
                                           mesh=mesh)
            return mm.multinomial_metrics(p, yt, w, mesh=mesh,
                                          domain=self.output["domain"])
        mu, sd = self.resp_stats
        pred = out[:, 0] * sd + mu
        yv = frame.col(y).numeric_view()
        w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
        yv = torch.where(torch.isnan(yv), 0.0, yv)
        return mm.regression_metrics(pred, yv, w, mesh=mesh)


def _export_weights_and_biases(model, device) -> None:
    """Each layer's weights (a column per input) and biases as frames in
    the DKV under ``<model>_weights_<i>`` / ``<model>_biases_<i>``, their
    keys in ``output["weights_keys"]`` / ``output["biases_keys"]``."""
    wkeys, bkeys = [], []
    for li, layer in enumerate(model.net):
        Wh = fetch(layer["W"]).astype(np.float64)
        wf = Frame.from_numpy({f"C{j + 1}": Wh[j]
                               for j in range(Wh.shape[0])},
                              device=device, key=f"{model.key}_weights_{li}")
        bf = Frame.from_numpy({"C1": fetch(layer["b"]).astype(
            np.float64).ravel()}, device=device,
            key=f"{model.key}_biases_{li}")
        wkeys.append(wf.key)
        bkeys.append(bf.key)
    model.output["weights_keys"] = wkeys
    model.output["biases_keys"] = bkeys


def opt_state_on(state, device):
    """A (nested) optimizer state's arrays as float32 tensors on
    ``device`` (copies), its scalars (momentum) as numpy float32."""
    if isinstance(state, dict):
        return {k: opt_state_on(v, device) for k, v in state.items()}
    if isinstance(state, list):
        return [opt_state_on(v, device) for v in state]
    if isinstance(state, torch.Tensor):
        return state.to(device, torch.float32).clone()
    if np.ndim(state):
        return torch.from_numpy(np.array(state, np.float32)).to(device)
    return np.float32(state)


# ---- the estimator ----------------------------------------------------------
class Training(NamedTuple):
    """A fit's state before its first step (``DeepLearningEstimator.
    prepare``)."""
    X: torch.Tensor              # the design [N, P]
    y: torch.Tensor              # class codes, or the float target
    w: torch.Tensor              # row weights, 0 on NA responses
    net: Net
    opt: list                    # the optimizer state (init_opt_state)
    gen: torch.Generator         # dropout draws
    cfg: StepConfig
    sched: Schedule
    n: int                       # the frame's rows
    done: int                    # steps already trained (checkpoint=)
    total: int                   # steps of the whole fit
    di: object                   # the DataInfo of the design
    category: Optional[str]      # None for the autoencoder
    resp_stats: Optional[Tuple[float, float]]
    hidden: List[int]
    shard: Optional[Shard] = None  # a rank's place in a data-parallel fit


class DeepLearningEstimator(ModelBuilder):
    """h2o-py H2ODeepLearningEstimator surface. ``rate_decay``, ``loss``,
    ``distribution``, ``max_w2``, ``reproducible``, ``score_interval``
    and ``train_samples_per_iteration`` are accepted and inert, as in the
    reference."""

    algo = "deeplearning"
    label = "DeepLearning"
    SHARDED = True

    DEFAULTS = dict(
        hidden=(200, 200), epochs=10.0, activation="Rectifier",
        adaptive_rate=True, rho=0.99, epsilon=1e-8,
        rate=0.005, rate_annealing=1e-6, rate_decay=1.0,
        momentum_start=0.0, momentum_ramp=1e6, momentum_stable=0.0,
        nesterov_accelerated_gradient=True,
        input_dropout_ratio=0.0, hidden_dropout_ratios=None,
        l1=0.0, l2=0.0, loss="auto", distribution="auto",
        standardize=True, mini_batch_size=1, seed=-1,
        autoencoder=False, export_weights_and_biases=False,
        nfolds=0, weights_column=None,
        fold_column=None, fold_assignment="auto", ignored_columns=None,
        stopping_rounds=5, stopping_metric="auto", stopping_tolerance=0.0,
        score_interval=5.0, train_samples_per_iteration=-2,
        score_training_samples=10000, score_validation_samples=0,
        use_all_factor_levels=False, max_w2=3.4e38, reproducible=False,
        checkpoint=None,
    )
    PORTED = frozenset(DEFAULTS)

    def _seed(self) -> int:
        s = int(self.params["seed"])
        return s if s >= 0 else DEFAULT_SEED

    def _response(self, frame: Frame, y: Optional[str], X, w):
        """(category, training target on the device, output width, loss
        category, w with NA responses at 0, regression (mean, sigma))."""
        dev = X.device
        if self.params["autoencoder"]:
            return None, X, X.shape[1], "mse", w, None
        category = infer_category(frame, y)
        rc = frame.col(y)
        if category == ModelCategory.REGRESSION:
            yv = rc.numeric_view()
            w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
            # the target's weighted mean and sigma in host float32, as the
            # reference computes them, over one device's layout of all the
            # rows (on every rank of a partitioned frame)
            n, N = frame.nrows, frame.one_device_rows
            yhost = np.nan_to_num(fetch_global(yv, n, N, frame.mesh))
            wn = fetch_global(w, n, N, frame.mesh)
            tot = max(wn.sum(), 1e-12)
            mu = float((yhost * wn).sum() / tot)
            sd = float(np.sqrt(np.maximum(
                ((yhost - mu) ** 2 * wn).sum() / tot, 1e-12)))
            y_dev = torch.from_numpy(frame.local_rows(
                ((yhost - mu) / sd)[:n])).to(dev)[:, None]
            return category, y_dev, 1, "mse", w, (mu, sd)
        host = rc.host_view()
        ok = frame.local_rows((~np.isnan(host)).astype(np.float32), 0.0)
        codes = frame.local_rows(np.nan_to_num(host).astype(np.int64), 0)
        w = w * torch.from_numpy(ok).to(dev)
        return (category, torch.from_numpy(codes).to(dev), rc.cardinality,
                "softmax", w, None)

    def _start(self, sizes, act, dev):
        """(net, optimizer state, dropout generator, step count) of a new
        fit or of a ``checkpoint=`` continuation."""
        p = self.params
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._seed() + 1)
        if p.get("checkpoint") is None:
            net = init_params(torch.Generator().manual_seed(self._seed()),
                              sizes, act == "maxout", dev)
            for l in net:
                for t in l.values():
                    t.requires_grad_(True)
            return (net, init_opt_state(net, bool(p["adaptive_rate"]),
                                        float(p["momentum_start"])), gen, 0)
        # continuation (DeepLearningModelInfo): ``epochs`` is the new
        # total; the donor's step count, optimizer state and dropout
        # generator carry on
        prior = resolve_checkpoint_model("deeplearning", p["checkpoint"],
                                         DeepLearningModel)
        have = [tuple(l["W"].shape) for l in prior.net]
        if have != layer_shapes(sizes, act == "maxout"):
            raise checkpoint_error(
                "deeplearning", "hidden",
                "Field _hidden cannot be modified if checkpoint is "
                "provided (hidden layout cannot change across checkpoint "
                "restart)")
        validate_checkpoint_params("deeplearning", prior.params, p,
                                   CHECKPOINT_FIXED)
        prior_epochs = float(prior.params.get("epochs", 0.0))
        if float(p["epochs"]) <= prior_epochs:
            raise checkpoint_error(
                "deeplearning", "epochs",
                f"If checkpoint is provided, epochs ({p['epochs']}) must be "
                "higher than the checkpoint model's epochs "
                f"({prior_epochs})")
        net = [{k: v.detach().to(dev, torch.float32).clone().requires_grad_(
            True) for k, v in l.items()} for l in prior.net]
        opt = (opt_state_on(prior._opt_state, dev)
               if prior._opt_state is not None
               else init_opt_state(net, bool(p["adaptive_rate"]),
                                   float(p["momentum_start"])))
        # a donor from another device type (or the reference) leaves the
        # generator at its seed
        if prior._gen_state is not None and prior._gen_state[0] == dev.type:
            gen.set_state(torch.from_numpy(np.array(prior._gen_state[1])))
        return net, opt, gen, int(prior._steps_trained or 0)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        if frame.partitioned and self.params.get("autoencoder"):
            raise NotImplementedError(
                "DeepLearning parameter 'autoencoder' on a frame partitioned "
                f"over a sharded mesh is not ported yet ({MESH_TODO})")
        with exact_f32():
            return self._fit_dl(frame, list(x), y, validation_frame)

    def prepare(self, frame: Frame, x: Sequence[str],
                y: Optional[str]) -> "Training":
        """The fit's state before its first step on ``frame``'s device:
        the design, target and weights, the net, optimizer state and
        dropout generator (or a ``checkpoint=`` donor's), the step
        configuration, the schedules and the step counts. ``_fit`` trains
        from it; ``train_steps(t.net, t.opt, t.X, t.y, t.w, t.gen, t.cfg,
        t.sched, step, 1, t.n)`` takes its steps one at a time."""
        p = self.params
        act, act_dropout = parse_activation(str(p["activation"]))
        di = build_datainfo(frame, list(x),
                            standardize=bool(p["standardize"]),
                            use_all_factor_levels=bool(
                                p["use_all_factor_levels"]))
        X = di.X
        dev = X.device
        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        category, y_dev, out_dim, cat_mode, w, resp_stats = self._response(
            frame, y, X, w)

        hidden = [int(h) for h in p["hidden"]]
        net, opt, gen, done = self._start([di.P] + hidden + [out_dim], act,
                                          dev)
        hd = p["hidden_dropout_ratios"]
        hd = (tuple(float(v) for v in hd) if hd is not None
              else tuple([0.5 if act_dropout else 0.0] * len(hidden)))

        n, N = frame.nrows, frame.one_device_rows
        batch = batch_size(n, N, int(p["mini_batch_size"]))
        if batch > N:
            raise ValueError(f"mini_batch_size {batch} exceeds the "
                             f"frame's {N} rows")
        cfg = StepConfig(act=act, category=cat_mode,
                         input_dropout=float(p["input_dropout_ratio"]),
                         hidden_dropout=hd, l1=float(p["l1"]),
                         l2=float(p["l2"]), adaptive=bool(p["adaptive_rate"]),
                         rho=float(p["rho"]), epsilon=float(p["epsilon"]),
                         nesterov=bool(p["nesterov_accelerated_gradient"]),
                         bf16=(bf16_route(dev) if batch >= BF16_MIN_BATCH
                               else None))
        sched = Schedule(float(p["rate"]), float(p["rate_annealing"]),
                         float(p["momentum_start"]),
                         float(p["momentum_stable"]),
                         float(p["momentum_ramp"]), batch)
        total = max(1, int(float(p["epochs"]) * n / batch))
        shard = None
        if frame.partitioned:
            lo, hi = frame.span
            shard = Shard(frame.mesh, lo, frame.local_nrows, hi, N,
                          torch.from_numpy(fetch_global(
                              w, n, N, frame.mesh)).to(dev))
        return Training(X, y_dev, w, net, opt, gen, cfg, sched, n,
                        min(done, total), total, di, category, resp_stats,
                        hidden, shard)

    def _fit_dl(self, frame: Frame, x: List[str], y: Optional[str],
                validation_frame: Optional[Frame]) -> Model:
        p = self.params
        t = self.prepare(frame, x, y)
        net, cfg, done, total = t.net, t.cfg, t.done, t.total
        stopper = EarlyStopper(int(p["stopping_rounds"]),
                               float(p["stopping_tolerance"]) or 1e-5)
        # chunks of 200 steps (25 for a tiny fit); the full-data loss is
        # read every score_stride steps (at most ~10 times a fit)
        chunk = 200 if total >= 25 else 25
        stride = max(chunk, -(-total // 10))
        next_score = stride
        history = []
        while done < total:
            k = min(chunk, total - done)
            train_steps(net, t.opt, t.X, t.y, t.w, t.gen, cfg, t.sched, done,
                        k, t.n, t.shard)
            done += k
            job_update(k / total, f"step {done}/{total}")
            if stopper.enabled and (done >= next_score or done >= total):
                next_score += stride
                with torch.no_grad():
                    lv = full_loss(net, t, cfg)
                history.append({"step": done, "loss": lv})
                if stopper.should_stop(lv):
                    break

        rc = None if (p["autoencoder"] or y is None) else frame.col(y)
        output = {"category": t.category or AUTOENCODER, "response": y,
                  "names": list(x),
                  "nclasses": (rc.cardinality if rc is not None
                               and rc.is_categorical else 1),
                  "domain": rc.domain if rc is not None else None,
                  "scoring_history": history, "hidden": t.hidden,
                  "activation": p["activation"], "bf16": cfg.bf16}
        model = DeepLearningModel(
            p, output, [{k: v.detach() for k, v in l.items()} for l in net],
            stats_of(t.di), list(x), cfg.act, bool(p["standardize"]),
            t.resp_stats)
        model._opt_state = t.opt
        model._steps_trained = int(done)
        model._gen_state = (t.X.device.type, t.gen.get_state().numpy())
        if p.get("export_weights_and_biases"):
            _export_weights_and_biases(model, t.X.device)
        nscore = int(p.get("score_training_samples") or 0)
        mask = None
        if nscore and t.n > nscore:
            mask = np.zeros(t.n, np.float32)
            mask[sample_rows(self._seed() & 0xFFFF, t.n, nscore)] = 1.0
            mask = frame.local_rows(mask)
        model.training_metrics = model._performance(frame, t.X, mask)
        if t.category == ModelCategory.BINOMIAL:
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        if validation_frame is not None:
            nv = int(p.get("score_validation_samples") or 0)
            vmask = None
            if nv and validation_frame.nrows > nv:
                vmask = np.zeros(validation_frame.nrows, np.float32)
                vmask[sample_rows(0xD2, validation_frame.nrows, nv)] = 1.0
                vmask = validation_frame.local_rows(vmask)
            model.validation_metrics = model.model_performance(
                validation_frame, mask_weights=vmask)
        return model
