"""SGD steps: `ops/grad.py::train_step` on a fixed batch of `rays` ray ids
around the frame's middle, toward a flat `target`, at learning rate `lr`;
step s draws its uniforms from (seed, s, 0).

Set-up warms every shape up on a copy of the parameters that the window
never sees, then puts the scene's own parameters back: the window starts
at step 0, and its first `check.steps` steps are the ones compared.  The
plain reference follows them from the same scene and uniforms.

- `loss_gap`: the relative gap of the first step's loss;
- `grad_gap`: the median, over the large elements of the counted leaves
  (the larger half of each leaf's moved elements), of the relative gap
  between the program's first gradient (as the update gets it) and the
  reference's;
- `change_gap`: the same for the parameters' change over the compared
  steps.

Leaves whose reference gradient norm is under LEAF_FLOOR of the median
leaf's are left out.  The median element, and not the norm of the worst
leaf: a few rays that graze a triangle or meet the glass near its
critical angle carry gradients far above the rest, so float32 rounding
alone moves a leaf's norm by up to its whole size (the reference in
float32 against itself in float64; PERF.md section 2), while most
elements agree to rounding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pb import reference as ref
from pb.faults import patched
from pb.program import Work as Base
from pb.program import label, render_settings, sync
from pb.uniforms import Source

BACKWARD = True
LEAF_FLOOR = 1e-3     # of the median leaf's gradient norm


class Work(Base):
    def setup(self) -> None:
        from simd_raytracer_tpu_torch.ops import grad as G
        self._load()
        self.G = G
        h, w = self.scene.height, self.scene.width
        n = int(self.traffic["rays"])
        total = h * w * self.cfg.samples_per_pixel
        self.rays_per_unit = n
        first_id = (total - n) // 2
        self.ids = torch.arange(n, dtype=torch.int32,
                                device=self.device) + first_id
        self.target = torch.full((n, 3), float(self.traffic["target"]),
                                 device=self.device,
                                 dtype=self.scene.vertices.dtype)
        self.lr = float(self.traffic["lr"])
        self.start, self.skeleton = G.split_params(self.scene)
        self.compared = int(self.traffic["check"]["steps"])
        with self.span("warm"):
            self.begin()
            for _ in range(int(self.traffic.get("warm_units", 2))):
                self.unit()
        self.begin()

    def begin(self) -> None:
        """A fresh copy of the scene's own parameters, at step 0."""
        self.params = {k: v.clone() for k, v in self.start.items()}
        self.next_unit = 0
        self.losses, self.grad, self.after = [], None, None

    def unit(self) -> float:
        s = self.next_unit
        self.next_unit += 1
        seen = []
        if s == 0:
            # The gradient as the update gets it: SGD keeps no state, so
            # it is taken where train_step hands it to the update.
            inner = self.G.loss_and_grad

            def spy(*a, **k):
                out = inner(*a, **k)
                seen.append(out[1])
                return out
            self.G.loss_and_grad = spy
        try:
            sync(self.device)
            t0 = time.perf_counter()
            with label("pb.step"):
                self.params, loss = self.G.train_step(
                    self.params, self.skeleton, self.cfg, self.ids,
                    self.target, self.source(s, 0), lr=self.lr,
                    accel=self.accel)
                value = float(loss)
            sync(self.device)
            dt = time.perf_counter() - t0
        finally:
            if s == 0:
                self.G.loss_and_grad = inner
        if s < self.compared:
            self.losses.append(value)
        if seen:
            self.grad = seen[0]
        if s == self.compared - 1:
            self.after = dict(self.params)
        return dt

    def answers(self) -> dict:
        """The compared steps' losses, the first gradient and the change
        over those steps, leaf by leaf, on the host."""
        grads = {k: _host(g) for k, g in (self.grad or {}).items()}
        change = {} if self.after is None else {
            k: _host(self.after[k].double() - v.double())
            for k, v in self.start.items()}
        return {"losses": list(self.losses), "grads": grads,
                "change": change}

    def free(self) -> None:
        self.scene = self.accel = self.params = self.skeleton = None
        self.start = self.grad = self.after = None


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def reference(doc, config, traffic, seed, device, dtype, got=None) -> dict:
    """Losses, first gradient and change of the reference following the
    compared SGD steps."""
    scene = ref.RefScene(doc, device, dtype)
    s = ref.Settings(**render_settings(config, traffic))
    n = int(traffic["rays"])
    total = scene.height * scene.width * s.spp
    ids = torch.arange(n, device=device) + (total - n) // 2
    target = torch.full((n, 3), float(traffic["target"]), device=device,
                        dtype=dtype)
    lr = float(traffic["lr"])
    params = {k: v.clone() for k, v in scene.params.items()}
    start = {k: v.clone() for k, v in params.items()}
    losses, grads = [], {}
    for step in range(int(traffic["check"]["steps"])):
        draws = ref.Draws(lambda u, c: Source(seed, u, c, device, dtype),
                          [(step, 0)],
                          torch.zeros(n, dtype=torch.long, device=device),
                          torch.arange(n, device=device), n)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        colors = ref.render_ids(scene, leaves, s, ids, draws)
        loss = torch.mean((colors - target) ** 2)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        g = {k: torch.zeros_like(v) if gi is None else gi
             for (k, v), gi in zip(leaves.items(), g)}
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: _host(v) for k, v in g.items()}
        with torch.no_grad():
            params = {k: v - lr * g[k] for k, v in params.items()}
    change = {k: _host(params[k].double() - start[k].double())
              for k in params}
    return {"losses": losses, "grads": grads, "change": change}


def as_answers(got: dict, answers: dict) -> dict:
    """Another trainer's answers (the control's) in the program's place."""
    return answers


def _counted(want: dict) -> list:
    norms = {k: float(np.linalg.norm(v)) for k, v in want["grads"].items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= LEAF_FLOOR * med]


def _median_gap(got: dict, want: dict, counted) -> float:
    """Median relative gap over the large elements of the counted leaves
    (the larger half of each leaf's moved elements); a leaf the program
    lacks or misshapes counts as infinitely far."""
    gaps = []
    for k in counted:
        w, g = want[k], got.get(k)
        moved = np.abs(w[w != 0])
        big = np.abs(w) >= (np.median(moved) if moved.size else np.inf)
        if g is None or g.shape != w.shape:
            gaps.append(np.full(int(big.sum()), np.inf))
            continue
        gap = np.abs(g[big] - w[big]) / np.abs(w[big])
        gaps.append(np.where(np.isfinite(gap), gap, np.inf))
    gaps = np.concatenate(gaps) if gaps else np.array([])
    return float(np.median(gaps)) if gaps.size else float("inf")


def _norm_gaps(got: dict, want: dict, counted) -> dict:
    """Each counted leaf's gap of norms over its own reference norm or
    the median leaf's, whichever is larger."""
    n = {k: float(np.linalg.norm(want[k])) for k in counted}
    med = float(np.median(list(n.values())))
    return {k: abs(float(np.linalg.norm(got[k])) - n[k]) / max(n[k], med)
            if k in got else float("inf") for k in counted}


def detail(got: dict, want: dict) -> dict:
    """For the record of `controls.py`: each counted leaf's gap of norms
    in the first gradient and in the change (the worst-leaf measure that
    the median element replaces), and its own median gap."""
    counted = _counted(want)
    return {"grads": _norm_gaps(got["grads"], want["grads"], counted),
            "change": _norm_gaps(got["change"], want["change"], counted),
            "grads_median": {k: _median_gap(got["grads"], want["grads"], [k])
                             for k in counted},
            "change_median": {k: _median_gap(got["change"], want["change"],
                                             [k]) for k in counted}}


def compare(got: dict, want: dict) -> dict:
    counted = _counted(want)
    # The first step's loss only: after one update, the backward's atomic
    # sums move the parameters in their last bits from run to run, a ray
    # or two then finds another winner, and each moves the loss by about
    # 1 / rays (PERF.md section 2).  The later steps are held through
    # change_gap.
    if len(got["losses"]) != len(want["losses"]):
        loss_gap = float("inf")
    else:
        loss_gap = abs(got["losses"][0] - want["losses"][0]) / abs(
            want["losses"][0])
    return {"loss_gap": float(np.nan_to_num(loss_gap, nan=np.inf)),
            "grad_gap": _median_gap(got["grads"], want["grads"], counted),
            "change_gap": _median_gap(got["change"], want["change"],
                                      counted)}


def unchanged():
    """The step returns the parameters it was given."""
    def make(inner):
        def train_step(params, *a, **kw):
            _, loss = inner(params, *a, **kw)
            return params, loss
        return train_step
    return patched("ops.grad", "train_step", make)


def half_batch():
    """The loss is the mean over the first half of the batch only."""
    def make(inner):
        def pixel_loss(params, skeleton, cfg, ids, target, *a, **kw):
            n = ids.shape[0] // 2
            return inner(params, skeleton, cfg, ids[:n], target[:n], *a,
                         **kw)
        return pixel_loss
    return patched("ops.grad", "pixel_loss", make)


def altered():
    """The vertices' gradient 5% too large where it is produced."""
    def make(inner):
        def loss_and_grad(*a, **kw):
            loss, grads = inner(*a, **kw)
            return loss, dict(grads, vertices=grads["vertices"] * 1.05)
        return loss_and_grad
    return patched("ops.grad", "loss_and_grad", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
