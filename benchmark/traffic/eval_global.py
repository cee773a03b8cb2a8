"""Traffic ``eval_global``: full retrieval evals back to back through a
global-descriptor family whose one encoder embeds both views (Sample4Geo's
ConvNeXt), the researcher's ``--test`` run over a paired test split.

It is ``eval``'s traffic (``benchmark.traffic.eval``: the same window,
evals, recall and check) with what differs for such a family: each eval
draws fresh uint8 pixels from the seed on the device at the model's input
sizes and no headings (nothing is cropped or polar-mapped); every batch of
the preset's eval batch (the last one ragged) goes through
``Sample4GeoPipeline.embed_step``; the gallery is ranked by
``euclidean_ranks`` (on unit vectors, cosine order), as
``train.loop.test_ranks`` ranks it. The weights are made here (``make_weights``),
and the reference is ``benchmark.reference.convnext``.

Parameters (the workload file's ``params``): ``pairs``, the test split's
size; ``check_queries``, the queries the outputs check samples. The check
compares ``emb_err`` and ``rank_gap`` as ``eval``'s does, and prints the
sampled queries' reference distances (their median, their spread over the
gallery, the true matches') beside them on standard error, so that a
collapse of the embeddings shows.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import reference, seeds, weights, work
from benchmark.reference import convnext as ref_convnext
from benchmark.reference import match as ref_match
from benchmark.reference import preprocess as ref_pre
from benchmark.reference.towers import blocks
from benchmark.traffic import eval as eval_traffic
from benchmark.work import convnext as convnext_work

REF_BLOCK = 32  # images per reference block

Draws = List[Tuple[str, Tuple[int, ...], float, float]]  # name, shape, mean, std


def weight_draws(m) -> Draws:
    """The encoder's leaves, each drawn as ``mean + std * N(0, 1)``: convs
    and linears LeCun-normal, their biases N(0, 0.02^2), LayerNorm weights
    N(1, 0.2^2) and biases N(0, 0.02^2) (away from 1 and 0, so that the
    check sees them), the layer scale N(g, (g / 5)^2) with g = 2 / sqrt(the
    stage's depth), so that a stage's branches sum to the order of the
    residual stream (at timm's 1e-6 init every block would be an
    identity), the logit scale its init. Larger biases, or a smaller
    layer scale, embed noise images nearer one common vector."""
    k, r = m.kernel_size, m.mlp_ratio
    out: Draws = []

    def affine(name, shape, fan_in):
        out.append((f"{name}.weight", shape, 0.0, 1.0 / math.sqrt(fan_in)))
        out.append((f"{name}.bias", (shape[0],), 0.0, 0.02))

    def norm(name, c):
        out.append((f"{name}.weight", (c,), 1.0, 0.2))
        out.append((f"{name}.bias", (c,), 0.0, 0.02))

    affine("model.stem.0", (m.dims[0], m.in_channels, 4, 4), 16 * m.in_channels)
    norm("model.stem.1", m.dims[0])
    for i, (c, depth) in enumerate(zip(m.dims, m.depths)):
        stage = f"model.stages.{i}"
        if i > 0:
            norm(f"{stage}.downsample.0", m.dims[i - 1])
            affine(f"{stage}.downsample.1", (c, m.dims[i - 1], 2, 2), 4 * m.dims[i - 1])
        g = 2.0 / math.sqrt(depth)
        for j in range(depth):
            blk = f"{stage}.blocks.{j}"
            affine(f"{blk}.conv_dw", (c, 1, k, k), k * k)
            norm(f"{blk}.norm", c)
            affine(f"{blk}.mlp.fc1", (r * c, c), c)
            affine(f"{blk}.mlp.fc2", (c, r * c), r * c)
            out.append((f"{blk}.gamma", (c,), g, g / 5.0))
    norm("model.head.norm", m.dims[-1])
    out.append(("logit_scale", (), m.logit_scale_init, 0.0))
    return out


def make_weights(m, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The encoder's float32 weights from ``seed``, made on ``device`` in one
    ``torch.randn`` (``weight_draws``), each fc2 row then centred: GELU's
    outputs have a positive mean, which fc2 would otherwise turn into one
    vector added to every image's features. ``{"surface": sd, "overhead":
    sd}``, one state dict ``sd`` for both views."""
    draws = weight_draws(m)
    sizes = [math.prod(shape) for _, shape, _, _ in draws]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd, offset = {}, 0
    for (name, shape, mean, std), n in zip(draws, sizes):
        sd[name] = flat[offset:offset + n].view(shape).mul_(std).add_(mean)
        if name.endswith("mlp.fc2.weight"):
            sd[name].sub_(sd[name].mean(dim=1, keepdim=True))
        offset += n
    return {"surface": sd, "overhead": sd}


class Driver(eval_traffic.Driver):
    # --- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from witw_tpu_torch.train.pipeline import make_pipeline

        d = self.cfg.data
        self.pipeline = make_pipeline(self.cfg, self.device)
        self.params = make_weights(self.cfg.model, self.seed, self.device)
        weights.check_layout(self.params, {"surface": self.pipeline.surface_model.state_dict(),
                                           "overhead": self.pipeline.overhead_model.state_dict()})
        c = d.channels
        self.surface = torch.empty(self.n, d.surface_height, d.surface_width_max, c,
                                   dtype=torch.uint8, device=self.device)
        self.overhead = torch.empty(self.n, d.overhead_size, d.overhead_size, c,
                                    dtype=torch.uint8, device=self.device)
        self.sample = np.sort(seeds.rng(self.seed, "sample").choice(self.n, self.n_check,
                                                                    replace=False))
        self.sample_t = torch.as_tensor(self.sample, device=self.device)
        self.warm_up()

    def draw(self, key) -> None:
        """Eval ``key``'s pixels into the fixed buffers."""
        gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "eval", key))
        self.surface.random_(0, 256, generator=gen)
        self.overhead.random_(0, 256, generator=gen)

    def embed(self):
        s_parts, o_parts = [], []
        for r in self.batch_bounds():
            s, o = self.pipeline.embed_step(self.params, {"surface": self.surface[r],
                                                          "overhead": self.overhead[r]})
            s_parts.append(s)
            o_parts.append(o)
        return torch.cat(s_parts), torch.cat(o_parts)

    def work(self) -> Dict:
        """The window's work by layer (``benchmark.work.convnext``, and the
        Euclidean sweep's product)."""
        d, m = self.cfg.data, self.cfg.model
        layers: Dict[str, list] = {"convnext_mixer": [], "convnext_mlp": [], "convnext_other": []}
        for b in work.batches(self.n, self.cfg.eval.batch_size):
            for h, w in ((d.surface_height, d.surface_width_max),
                         (d.overhead_size, d.overhead_size)):
                for layer, calls in convnext_work.encoder_work(
                        b, h, w, m.depths, m.dims, m.in_channels, m.kernel_size,
                        m.mlp_ratio).items():
                    layers[layer] += calls
        layers["euclidean"] = [work.euclidean_work(self.n, self.n, m.dims[-1])]
        per = work.per_layer(layers, self.evals)
        return {"layers": per, "steps": self.evals, "pairs": self.evals * self.n,
                "model_ops_s": sum(v["ops_s"] for v in per.values())}

    # --- the outputs check ------------------------------------------------

    def reference_embeddings(self, quantize=None):
        """(sampled queries' embeddings, the whole gallery's) by the
        reference, from the checked eval's pixels."""
        d, m = self.cfg.data, self.cfg.model
        w = self.params["surface"]

        def embed(pixels):
            x = ref_pre.normalize(pixels, d.img_mean, d.img_std).permute(0, 3, 1, 2).contiguous()
            return ref_convnext.encoder(x, w, m.depths, quantize)

        with torch.no_grad(), reference.exact():
            s_out = [embed(self.surface[self.sample_t[blk]])
                     for blk in blocks(self.n_check, REF_BLOCK)]
            o_out = [embed(self.overhead[blk])
                     for blk in blocks(self.n, REF_BLOCK)]
        return torch.cat(s_out), torch.cat(o_out)

    def distances(self, o_all, s_sample):
        d = ref_match.euclidean_sq_distances(o_all, s_sample)
        if self.reference_distances is None:  # a check's first call: the reference's
            self.reference_distances = d
        return d

    def check(self, control: bool = False) -> Dict[str, float]:
        """``eval``'s check, then the reference distances' spread on
        standard error."""
        self.reference_distances = None
        out = super().check(control)
        print(spread_line(self.reference_distances, self.sample_t, out), file=sys.stderr)
        return out


def spread_line(dist: torch.Tensor, true_match: torch.Tensor, checks: Dict[str, float]) -> str:
    """The sampled queries' squared reference distances [G, Q] in one line:
    their median, the median over queries of their interquartile range over
    the gallery, the true matches' median, beside the checked numbers."""
    d = dist.to(torch.float64)
    q = torch.quantile(d, torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64, device=d.device),
                       dim=0)
    true = d[true_match, torch.arange(d.shape[1], device=d.device)]
    parts = [f"median {float(q[1].median()):.6g}",
             f"median IQR over the gallery {float((q[2] - q[0]).median()):.6g}",
             f"true matches' median {float(true.median()):.6g}"]
    parts += [f"{k} {v:.6g}" for k, v in sorted(checks.items())]
    return "sampled queries' squared reference distances: " + ", ".join(parts)
