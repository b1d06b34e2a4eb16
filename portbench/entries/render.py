"""The render entry: the window drives the program's
`PanoramaGenerator.render` (synthesis.py, the per-batch call of render.main),
closed loop with one client: a request is one batch of beats under the
mix's viewpoint grid, and it ends when its views are ready on the device.

Set-up builds the one generator (which folds the decoder's BatchNorm for the
streamed-basis kernel A1), moves the pool of beats to the device and renders
WARMUP requests, holding SAMPLE outputs at once: that warms up every shape of
the cell and leaves the allocator the blocks the window's reservoir holds.
While the window runs, a reservoir drawn from the seed keeps SAMPLE of its
requests' outputs; `check` renders their beats again with the plain
reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import compare
from portbench.reference import nefnet as ref
from portbench.traffic import generator

SAMPLE = 4
WARMUP = SAMPLE + 2


class State:
    pass


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def setup(ctx):
    from electrocardio_panorama_tpu_torch.models import build_model
    from electrocardio_panorama_tpu_torch.synthesis import PanoramaGenerator

    cell = ctx.cell
    st = State()
    st.cell, st.seed, st.device = cell, ctx.seed, ctx.device
    st.params = {k: v.detach() for k, v in ctx.params.items()}
    st.bn_state = ctx.bn_state
    pool = generator.pool(cell.mix, cell.data_cfg(), ctx.seed)
    st.pool = [{k: torch.as_tensor(b[k]).to(ctx.device) for k in ("data", "input_theta", "rois")} for b in pool]
    st.views = generator.view_grid(cell.mix["n_theta"], cell.mix["n_phi"])
    st.gen = PanoramaGenerator(build_model(ctx.cfg), st.params, st.bn_state,
                               compute_dtype=getattr(torch, ctx.cfg.TPU.compute_dtype), use_fused=True,
                               device=ctx.device)
    st.requests = 0
    st.kept, st.rng = {}, np.random.default_rng(np.random.SeedSequence([ctx.seed, 0x5A3])).random
    held = [_request(st) for _ in range(WARMUP)]
    del held
    _sync(st)
    return st


def _request(st):
    b = st.pool[st.requests % len(st.pool)]
    out = st.gen.render(b["data"], b["input_theta"], b["rois"], st.views)
    _sync(st)
    st.requests += 1
    return out


def window(st, seconds: float) -> dict:
    """Requests until `seconds` have passed; each timed from its call to its
    output ready on the device."""
    _sync(st)
    lat = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        if a - t0 >= seconds:
            break
        out = _request(st)
        lat.append(time.perf_counter() - a)
        n = len(lat)  # reservoir sampling of the window's requests
        if n <= SAMPLE:
            st.kept[st.requests - 1] = out
        elif st.rng() < SAMPLE / n:
            del st.kept[sorted(st.kept)[int(st.rng() * SAMPLE)]]
            st.kept[st.requests - 1] = out
    t = time.perf_counter() - t0 if lat else seconds
    views = len(lat) * st.cell.mix["batch"] * len(st.views)
    return {"seconds": t, "attempted": len(lat), "failed": 0,
            "metrics": {"render_views_per_s": views / t,
                        "render_p95_ms": 1e3 * float(np.percentile(lat, 95)) if lat else float("nan")}}


def check(st) -> dict:
    """Free the generator, then render each kept request's beats with the
    plain reference and compare."""
    kept = st.kept
    del st.gen
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    views = torch.as_tensor(st.views, device=st.device)
    gap = 0.0
    for r, out in sorted(kept.items()):
        want = ref.render(st.cell.model, st.params, st.bn_state, st.pool[r % len(st.pool)], views,
                          st.cell.lead_num)
        gap = max(gap, compare.view_gap(out, want))
    return {"view_gap": gap if kept else float("inf")}
