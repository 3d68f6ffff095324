"""`field-train`: Feature 3DGS training (its speed-up module, an LSeg-wide
teacher), one camera a step. `render_gaussians(use_sh=True,
point_features=...)` blends the SH colour and the (N, C) semantic features
in one pass; the port's `FeatureDecoder` resizes the feature map to the
teacher's size and lifts it by a 1x1 convolution to the teacher's width;
the loss is L1 on the colour plus gamma L1 of the decoded map against the
view's teacher map; `loss.backward()`, then `ParameterClass.step`
(FractionalAdam, unit weights) over the five gaussian groups and
`semantic_feature`, and Adam over the decoder's W and b
(`torch.optim.Adam`, as the paper steps it).

The camera path is `train`'s, in an order drawn from the configuration's
`geometry_seed` and not from --seed: a 20 s window of ~75 steps takes the
64 views once and ~11 of them again, and the views' slots differ by up to
a fifth, so an order drawn from --seed would change the window's work from
run to run (the step time spread 0.9% over six seeds that way, PERF.md
§2). --seed draws the features, the targets and the teacher maps.

Targets: `traffic["targets"]` seeded pairs held on the device, a colour
image and a teacher map whose every pixel is a unit 512-vector, used view
mod the pairs. The first `checked_steps` of the set-up steps are compared
with `splatbench/field_reference.py` as `train` compares its own
(`loss_gap_first`, `grad_gap` over every leaf, the semantic features and
the decoder's W and b included, `change_gap`), the decoder's two leaves
each over its own norm (`compare`).

A port whose `render_gaussians` takes no `point_features`, or that has no
`models.feature_decoder`, cannot run the cell: set-up stops at once with
an error that says so.

Measures: `step_ms` (the whole window, closed by a synchronize, over the
steps completed); the run adds `peak_gib`."""

import inspect
from pathlib import Path
from typing import Dict

import torch

from splatbench import field_reference, harness, runner, scenes

train = harness.load_part("entries", "train", Path(__file__).resolve().parents[2])
Train = train.Train

BETA1 = 0.9   # FractionalAdam's and torch.optim.Adam's default, which the cell uses
SEMANTIC = "semantic_feature"
DECODER = ("decoder_weight", "decoder_bias")


def require_field_support(tgr) -> None:
  """Stop unless the port blends point features and has the decoder."""
  if "point_features" not in inspect.signature(tgr.render_gaussians).parameters:
    raise RuntimeError("this port's render_gaussians takes no point_features: "
                       "it cannot blend a feature field with the colour")
  try:
    from taichi_gaussian_rasterizer_tpu_torch.models import feature_decoder  # noqa: F401
  except ImportError as e:
    raise RuntimeError(f"this port has no models.feature_decoder: {e}") from e


class FieldTrain(Train):

  def setup(self):
    require_field_support(self.tgr)
    # the configuration's float32: the decoder's products in FP32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    super().setup()

  # -- seeded inputs ---------------------------------------------------------

  def make_inputs(self):
    super().make_inputs()
    tr, geometry_seed = self.traffic, self.cfg["geometry_seed"]
    self.path = scenes.camera_path(self.camera, tr["views"], tr["max_angle_deg"],
                                   tr["shift_frac"] * self.median_depth,
                                   geometry_seed, geometry_seed)
    self.cameras = [runner.to_camera(self.tgr, c) for c in self.path]

  def field_init(self, device) -> Dict[str, torch.Tensor]:
    """The semantic features and the decoder's W and b, from --seed: the
    features uniform in [-0.5, 0.5), W and b as torch.nn.Conv2d starts
    them, uniform within +-1/sqrt(C)."""
    field, n = self.cfg["field"], self.cfg["scene"]["points"]
    c, c_out = field["channels"], field["decoded_channels"]
    gen = scenes.generator(scenes.derive_seed(self.seed, 20), device)
    semantic = torch.rand((n, c), generator=gen, device=device) - 0.5
    gen = scenes.generator(scenes.derive_seed(self.seed, 21), device)
    bound = c ** -0.5
    w = (torch.rand((c_out, c), generator=gen, device=device) * 2 - 1) * bound
    b = (torch.rand((c_out,), generator=gen, device=device) * 2 - 1) * bound
    return {SEMANTIC: semantic, "decoder_weight": w, "decoder_bias": b}

  def make_teacher(self, index: int, device) -> torch.Tensor:
    """(H', W', 512): every pixel a seeded unit vector."""
    field = self.cfg["field"]
    w, h = field["teacher_size"]
    gen = scenes.generator(scenes.derive_seed(self.seed, 200 + index), device)
    t = torch.randn((h, w, field["decoded_channels"]), generator=gen, device=device)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)

  def prepare(self):
    from taichi_gaussian_rasterizer_tpu_torch.models import FeatureDecoder
    from taichi_gaussian_rasterizer_tpu_torch.optim import (FractionalAdam,
                                                            ParameterClass)
    device = self.dev.device
    field = self.cfg["field"]
    self.targets = [runner.make_target(self.cfg, 3, self.seed, t, device)
                    for t in range(self.traffic["targets"])]
    self.teachers = [self.make_teacher(t, device)
                     for t in range(self.traffic["targets"])]
    init = self.field_init(device)
    self.params = ParameterClass.create(
        dict(self.gaussians, **{SEMANTIC: init[SEMANTIC]}),
        {k: {"lr": v} for k, v in self.lrs.items()}, optimizer=FractionalAdam)
    self.decoder = FeatureDecoder(field["channels"], field["decoded_channels"],
                                  device=device)
    with torch.no_grad():
      self.decoder.weight.copy_(init["decoder_weight"])
      self.decoder.bias.copy_(init["decoder_bias"])
    self.decoder_opt = torch.optim.Adam(self.decoder.parameters(),
                                        lr=field["decoder_learning_rate"])
    self.ones = torch.ones(self.params.num_points, dtype=torch.float32,
                           device=device)
    self.teacher_hw = tuple(field["teacher_size"][::-1])
    self.gamma = field["feature_loss_weight"]

  # -- a step ----------------------------------------------------------------

  def step(self, i: int, span=None):
    v = self.view(i)
    keys = scenes.GAUSSIAN_KEYS + (SEMANTIC,)
    leaves = {k: self.params.tensors[k].detach().requires_grad_() for k in keys}
    r = self.tgr.render_gaussians(
        self.tgr.Gaussians3D(**{k: leaves[k] for k in scenes.GAUSSIAN_KEYS}),
        self.cameras[v], self.config, use_sh=True,
        point_features=leaves[SEMANTIC])
    decoded = self.decoder(r.feature_map, self.teacher_hw)
    t = v % len(self.targets)
    loss = (torch.mean(torch.abs(r.image - self.targets[t]))
            + self.gamma * torch.mean(torch.abs(decoded - self.teachers[t])))
    loss.backward()
    if span is not None:
      span.start()
    self.params.step({k: leaves[k].grad for k in keys}, weight=self.ones)
    self.decoder_opt.step()
    self.decoder_opt.zero_grad(set_to_none=True)
    if span is not None:
      self.spans.setdefault("optim", []).append(span.stop())
    if i == 0:
      self.decoder_g1 = {k: (self.decoder_opt.state[p]["exp_avg"] / (1.0 - BETA1)).cpu()
                         for k, p in self.decoder_params()}
    if i == self.traffic["checked_steps"] - 1:
      self.decoder_after = {k: p.detach().cpu().clone()
                            for k, p in self.decoder_params()}
    return loss.detach()

  def decoder_params(self):
    return (("decoder_weight", self.decoder.weight),
            ("decoder_bias", self.decoder.bias))

  # -- per-layer probes ------------------------------------------------------

  def probe_frame(self, gaussians_dict: Dict, view: int):
    """The blend's inputs as `render_gaussians` builds them with the
    semantic features: the SH colour, then the (N, C) features."""
    frame = super().probe_frame(gaussians_dict, view)
    frame.feats = torch.cat([frame.feats, gaussians_dict[SEMANTIC]], 1).contiguous()
    return frame

  def work(self, frame) -> Dict:
    """The frame's counts: the colour frame's (the active pairs and slots
    do not depend on the features), at 3 + C blended channels."""
    return dict(super().work(frame),
                n_features=3 + self.cfg["field"]["channels"])

  # -- the check -------------------------------------------------------------

  def free(self):
    super().free()
    self.decoder = None
    self.decoder_opt = None

  def readings(self) -> Dict:
    g1 = dict(self.g1, **self.decoder_g1)
    after = dict(self.after, **self.decoder_after)
    return dict(losses=self.losses, g1=g1, after=after)

  def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
    """`train`'s numbers, with the decoder's W and b each held by its own
    norm in `grad_gap` and `change_gap`: over the median leaf's norm,
    hundreds of times theirs, a decoder stepped at a rate off by a fifth,
    or a bias never stepped, would pass."""
    numbers = train.train_numbers(prog, ref)
    init = ref["init"]
    for k in DECODER:
      grad = train.leaf_gaps({k: prog["g1"][k]}, {k: ref["g1"][k]}, diff=False)
      change = train.leaf_gaps({k: prog["after"][k].to(init[k].device) - init[k]},
                               {k: ref["after"][k] - init[k]}, diff=False)
      numbers["grad_gap"] = max(numbers["grad_gap"], grad)
      numbers["change_gap"] = max(numbers["change_gap"], change)
    return numbers

  def reference_readings(self, tf32: bool = False, half: bool = False) -> Dict:
    """The reference's first steps from the seeded scene
    (`field_reference.train_steps`); with `half`, each step's loss is taken
    over the top half of the image and of the teacher's map."""
    device = self.dev.device
    _, init = scenes.make_scene(self.cfg, self.seed, device, self.cell.root)
    field = self.field_init(device)
    init[SEMANTIC] = field.pop(SEMANTIC)
    views = [self.view(i) for i in range(self.traffic["checked_steps"])]

    def targets(i):
      t = views[i] % len(self.targets)
      return self.targets[t], self.teachers[t]

    rows = slice(0, self.cfg["image_size"][1] // 2) if half else None
    return field_reference.train_steps(
        init, field, self.lrs, self.cfg["field"]["decoder_learning_rate"],
        [self.path[v] for v in views], self.cfg, targets,
        self.traffic["checked_steps"], tf32, rows)


ENTRY = FieldTrain
