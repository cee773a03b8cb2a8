"""Traffic ``eval``: full retrieval evals back to back, the researcher's
``--test`` run over a paired test split.

Each eval draws fresh pixels from the seed on the device into fixed uint8
buffers (the type the port's loader hands ``embed_all``) and fresh crop
headings, embeds every pair through ``FovPipeline`` / ``SafaPipeline
.embed_step`` in batches of the preset's eval batch (the last one ragged),
then ranks the gallery as ``train.loop.test_ranks`` does (FOV:
``FovGalleryEvaluator`` with the preset's query block and gallery chunk,
the fused match unless the preset asks for the FFT sweep; SAFA:
``euclidean_ranks``) and reduces the ranks to recall (``metrics_from_ranks``).
This is ``test_ranks``'s body; ``embed_all`` takes no headings from the
caller, and ``embed_step`` does, so the benchmark makes them and hands the
same to the reference.

Parameters (the workload file's ``params``): ``pairs``, the test split's
size; ``check_queries``, the queries the outputs check samples.

The check takes one eval of the window, drawn from the seed, and a sample
of its queries: the reference embeds those queries and the whole gallery
from the same pixels and headings, and the check compares ``emb_err``, the
largest relative error of a sampled row of either tower's embeddings, and
``rank_gap``, the widest distance error that the program's ranks of the
sampled queries imply against the reference's distances.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import reference, seeds, weights, work
from benchmark.reference import match as ref_match
from benchmark.reference import preprocess as ref_pre
from benchmark.reference import towers as ref_towers

REF_BLOCK = 32  # images per reference block


class Driver:
    def __init__(self, cfg, conf: Dict, cell: Dict, seed: int, device):
        self.cfg, self.conf, self.cell, self.seed = cfg, conf, cell, seed
        self.device = torch.device(device)
        p = cell["params"]
        self.n = int(p["pairs"])
        self.n_check = min(int(p["check_queries"]), self.n)
        self.family = cfg.model.kind
        self.kept: List = []

    # --- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from witw_tpu_torch.evaluation.gallery import FovGalleryEvaluator
        from witw_tpu_torch.train.pipeline import make_pipeline

        cfg, d = self.cfg, self.cfg.data
        self.pipeline = make_pipeline(cfg, self.device)
        self.params = weights.make(cfg, self.seed, self.device)
        weights.check_layout(self.params, {"surface": self.pipeline.surface_model.state_dict(),
                                           "overhead": self.pipeline.overhead_model.state_dict()})
        c = d.channels
        self.surface = torch.empty(self.n, d.surface_height, d.surface_width_max, c,
                                   dtype=torch.uint8, device=self.device)
        self.overhead = torch.empty(self.n, d.overhead_size, d.overhead_size, c,
                                    dtype=torch.uint8, device=self.device)
        self.starts = torch.empty(self.n, dtype=torch.int64, device=self.device)
        self.sample = np.sort(seeds.rng(self.seed, "sample").choice(self.n, self.n_check,
                                                                    replace=False))
        self.sample_t = torch.as_tensor(self.sample, device=self.device)
        if self.family == "fov_dsm":
            self.evaluator = FovGalleryEvaluator(
                query_block=cfg.eval.query_block, gallery_chunk=cfg.eval.gallery_chunk,
                use_fused=not cfg.eval.fast_matmul, fast_matmul=cfg.eval.fast_matmul)
        self.warm_up()

    def draw(self, key) -> None:
        """Eval ``key``'s pixels and headings into the fixed buffers."""
        gen = torch.Generator(device=self.device).manual_seed(seeds.derive(self.seed, "eval", key))
        self.surface.random_(0, 256, generator=gen)
        self.overhead.random_(0, 256, generator=gen)
        if self.cfg.data.random_orientation:
            self.starts.random_(0, self.cfg.data.surface_width_max, generator=gen)
        else:
            self.starts.zero_()

    def batch_bounds(self) -> List[slice]:
        b = self.cfg.eval.batch_size
        return [slice(i, min(i + b, self.n)) for i in range(0, self.n, b)]

    def embed(self):
        s_parts, o_parts = [], []
        for r in self.batch_bounds():
            batch = {"surface": self.surface[r], "overhead": self.overhead[r]}
            s, o = self.pipeline.embed_step(self.params, batch, draws=self.starts[r])
            s_parts.append(s)
            o_parts.append(o)
        return torch.cat(s_parts), torch.cat(o_parts)

    def rank(self, o_emb, s_emb) -> np.ndarray:
        from witw_tpu_torch.evaluation.gallery import euclidean_ranks

        if self.family == "fov_dsm":
            return self.evaluator.ranks(o_emb, s_emb)
        return euclidean_ranks(o_emb, s_emb)

    def warm_up(self) -> None:
        """One whole eval on inputs of its own: every shape the window runs
        (the ragged last batch, the sweep's last block and chunk) and the
        memory it holds, so that nothing is built or allocated anew in the
        window (a first eval without it ran 0.05-0.5 s long)."""
        self.draw("warm-up")
        self.evaluate()

    def evaluate(self):
        """One eval of the buffers' pairs: (ranks, surface and overhead
        embeddings)."""
        from witw_tpu_torch.evaluation.gallery import metrics_from_ranks

        s_emb, o_emb = self.embed()
        ranks = self.rank(o_emb, s_emb)  # on the host: the device has finished
        metrics_from_ranks(ranks)
        return ranks, s_emb, o_emb

    # --- the window -------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        """Evals back to back, each on fresh inputs, until ``seconds`` have
        passed; the last one runs to its end."""
        evals = 0
        start_ns = time.time_ns()
        t0 = time.perf_counter()
        ends = []
        while True:
            self.draw(evals)
            ranks, s_emb, o_emb = self.evaluate()
            self.kept.append((ranks, s_emb[self.sample_t].clone(), o_emb[self.sample_t].clone()))
            evals += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        elapsed = ends[-1]
        self.evals = evals
        return {"eval_pairs_per_s": evals * self.n / elapsed, "attempted": evals, "failed": 0,
                "window_s": elapsed, "window_ns": (start_ns, start_ns + int(elapsed * 1e9)),
                "request_s": np.diff([0.0] + ends).tolist()}

    def work(self) -> Dict:
        """The window's work by layer (``benchmark.work``)."""
        d, m = self.cfg.data, self.cfg.model
        sw = d.surface_width
        towers: Dict[str, list] = {"conv3x3_bf16": [], "tower_other": []}
        for b in work.batches(self.n, self.cfg.eval.batch_size):
            for w_in in (sw, d.surface_width_max):
                convs = (work.fov_tower_convs(b, d.surface_height, w_in, d.channels)
                         if self.family == "fov_dsm"
                         else work.vgg_convs(b, d.surface_height, w_in, d.channels)[0])
                for conv in convs:
                    towers["conv3x3_bf16" if conv.stride_h == 1 else "tower_other"].append(
                        conv.work())
                if self.family == "vgg_safa":
                    h, w = d.surface_height // 8, w_in // 8
                    towers["tower_other"].append(
                        work.safa_head_work(b, h * w, 512, m.num_heads, m.reduction))
        if self.family == "fov_dsm":
            h, w, c = work.fov_map_shape(d.surface_height, d.surface_width_max)
            sw_map = work.fov_map_shape(d.surface_height, sw)[1]
            sweep = "fft_sweep" if self.cfg.eval.fast_matmul else "fused_match"
            towers[sweep] = work.sweep_work(self.n, self.cfg.eval.query_block,
                                            self.cfg.eval.gallery_chunk, w, sw_map, h * c)
        else:
            towers["euclidean"] = [work.euclidean_work(self.n, self.n, m.num_heads * 512)]
        layers = work.per_layer(towers, self.evals)
        return {"layers": layers, "steps": self.evals, "pairs": self.evals * self.n,
                "model_ops_s": sum(v["ops_s"] for v in layers.values())}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("pipeline", "evaluator"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the outputs check ------------------------------------------------

    def reference_embeddings(self, quantize=None):
        """(sampled queries' embeddings, the whole gallery's) by the
        reference, from the checked eval's pixels and headings."""
        d = self.cfg.data
        w = self.params
        tower = ref_towers.fov_tower if self.family == "fov_dsm" else ref_towers.safa_tower
        s_out, o_out = [], []
        with torch.no_grad(), reference.exact():
            for blk in ref_towers.blocks(self.n_check, REF_BLOCK):
                rows = self.sample_t[blk]
                x = ref_pre.surface_input(self.surface[rows], self.starts[rows], d.surface_width,
                                          d.img_mean, d.img_std)
                s_out.append(tower(x, w["surface"], False, quantize))
            for blk in ref_towers.blocks(self.n, REF_BLOCK):
                x = ref_pre.overhead_input(self.overhead[blk], d.surface_height,
                                           d.surface_width_max, d.img_mean, d.img_std)
                o_out.append(tower(x, w["overhead"], True, quantize))
        return torch.cat(s_out), torch.cat(o_out)

    def distances(self, o_all, s_sample):
        if self.family == "fov_dsm":
            return ref_match.chord_distances(o_all, s_sample)
        return ref_match.euclidean_sq_distances(o_all, s_sample)

    def checked_eval(self) -> int:
        return int(seeds.rng(self.seed, "checked eval").integers(len(self.kept)))

    def check(self, control: bool = False) -> Dict[str, float]:
        """``emb_err`` and ``rank_gap`` of one eval of the window; with
        ``control`` also the same numbers of the reference computed in fp8
        put in the program's place (``control_emb_err``,
        ``control_rank_gap``)."""
        k = self.checked_eval()
        ranks, s_prog, o_prog = self.kept[k]
        self.draw(k)
        s_ref, o_ref = self.reference_embeddings()
        dist = self.distances(o_ref, s_ref)
        out = {
            "emb_err": max(ref_match.relative_error(s_prog, s_ref),
                           ref_match.relative_error(o_prog, o_ref[self.sample_t])),
            "rank_gap": ref_match.rank_gap(dist, self.sample_t, ranks[self.sample]),
        }
        if control:
            s_ctl, o_ctl = self.reference_embeddings(reference.fp8_round)
            ctl_ranks = ref_match.ranks(self.distances(o_ctl, s_ctl), self.sample_t)
            out["control_emb_err"] = max(ref_match.relative_error(s_ctl, s_ref),
                                         ref_match.relative_error(o_ctl[self.sample_t],
                                                                  o_ref[self.sample_t]))
            out["control_rank_gap"] = ref_match.rank_gap(dist, self.sample_t, ctl_ranks)
        return out
