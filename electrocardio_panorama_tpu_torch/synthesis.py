"""Electrocardio Panorama synthesis: the north-star workload.

Reference demo.ipynb builds a dense 84-view grid (7 theta x 12 phi) and
decodes each view in turn (model_nefnet.py:185-190). Here every batch encodes
once and decodes all its views together; with `use_fused=True` the decode is
the streamed-basis CUDA kernel (ops/kernels/decoder_fused.py).

Synthesis from scratch: the reference ships the latent -> ECG decode but no
latent source (README.md:19-22); `GaussianLatentPrior` is a diagonal
Gaussian fitted over dataset latents, and `synthesize_from_scratch` decodes
its samples (synth_cli.py drives both).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from electrocardio_panorama_tpu_torch.ops import angular_encode
from electrocardio_panorama_tpu_torch.ops.kernels.decoder_fused import fold_decoder_bn, fused_decode_views
from electrocardio_panorama_tpu_torch.utils import resolve_device
from electrocardio_panorama_tpu_torch.utils.profiling import span

# Outputs stay on the device within a window and drain to the host once the
# window passes this many bytes: no per-batch sync, and device memory stays
# O(window) whatever the dataset size.
_DEVICE_ACCUM_BYTES = 256 << 20


def theta_grid(n_theta: int = 7, n_phi: int = 12) -> np.ndarray:
    """The demo notebook's dense viewpoint grid (demo.ipynb cell 2) at its
    default 7x12=84 size; other densities keep the same endpoint layout."""
    if n_theta == 7:
        thetas = np.array([np.pi / 24] + [np.pi * k / 6 for k in range(1, 6)] + [np.pi * 23 / 24])
    else:
        thetas = np.linspace(np.pi / 24, np.pi * 23 / 24, n_theta)
    phis = -np.pi + np.arange(n_phi) * (np.pi / 6 if n_phi == 12 else 2 * np.pi / n_phi)
    grid = np.stack(np.meshgrid(thetas, phis, indexing="ij"), axis=-1)  # [T, P, 2]
    return grid.reshape(-1, 2).astype(np.float32)


def encode_fn(model_def, use_fused: bool, *, plain: bool = False):
    """The render's encode, `fn(params, x, input_thetas, rois) ->
    NefNetLatents`: under `use_fused` the model definition's fused encode
    where it has one, else its eager `encode`."""
    if use_fused and model_def.fused_encode is not None:
        return model_def.fused_encode(plain=plain)
    return model_def.encode


class PanoramaGenerator:
    """Encode-once / decode-many panorama renderer (demo.ipynb Generator).

    `use_fused=True` decodes with the streamed-basis kernel (BN folded, the
    gate/upsample/conv1 head as a rank-J basis mix) and, where the model
    definition has one (`fused_encode`: Nef-Net's, kernel A2 in eval form),
    encodes through the fused encoder; Nef-Net2 encodes eagerly. `compute_dtype`
    bfloat16 runs the encode in bf16 and the kernels with bf16 storage and
    float32 accumulation; float32 keeps full precision throughout.
    `plain=True` runs the kernels' plain PyTorch versions instead, on the same
    device, to hold the kernels against them.
    """

    def __init__(self, model_def, params, bn_state, *, compute_dtype=torch.float32,
                 use_fused: bool = False, v_tile: int = 16, device=None, plain: bool = False):
        self.model = model_def
        self.device = resolve_device(device)
        self.dtype = compute_dtype
        self.use_fused = use_fused
        self.v_tile = v_tile
        self.plain = plain
        params = {k: v.to(self.device) for k, v in params.items()}
        self.bn_state = {k: v.to(self.device) for k, v in bn_state.items()}
        self.params = {k: v.to(compute_dtype) if v.is_floating_point() else v
                       for k, v in params.items()}
        self._folded = (fold_decoder_bn(params, self.bn_state, dtype=compute_dtype)
                        if use_fused else None)
        self._encode = encode_fn(model_def, use_fused, plain=plain)

    @torch.no_grad()
    def encode(self, data, input_theta, rois):
        return self._encode(
            self.params, torch.as_tensor(data, device=self.device).to(self.dtype),
            torch.as_tensor(input_theta, device=self.device).to(self.dtype),
            torch.as_tensor(rois, device=self.device),
        ).latent_all

    @torch.no_grad()
    def render(self, data, input_theta, rois, views) -> torch.Tensor:
        """data [B,L,512], views [V,2] (shared) or [B,V,2] -> [B,V,512] on the device."""
        with span("ecgpan.render"):
            with span("ecgpan.encode", device=self.device):
                latent = self.encode(data, input_theta, rois)
            v = torch.as_tensor(views, device=self.device).to(self.dtype)
            if v.ndim == 2:
                v = v[None].expand(latent.shape[0], *v.shape)
            if self._folded is not None:
                enc = angular_encode(v, self.model.theta_encoder_len)
                return fused_decode_views(self._folded, latent, enc=enc, v_tile=self.v_tile,
                                          plain=self.plain)
            return self.model.decode_views(self.params, self.bn_state, latent, v)

    def render_dataset(self, loader, views: np.ndarray, out_path: str | None = None,
                       max_batches: int | None = None):
        """demo.ipynb cells 3-4: render every test batch under the dense grid,
        save all_theta_data.npz (rest_out + rois)."""
        host, outs, rois_all, pending = [], [], [], 0
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            out = self.render(batch["data"], batch["input_theta"], batch["rois"], views)
            outs.append(out)
            rois_all.append(batch["rois"])
            pending += out.numel() * out.element_size()
            if pending >= _DEVICE_ACCUM_BYTES:
                host.extend(o.float().cpu().numpy() for o in outs)
                outs, pending = [], 0
        host.extend(o.float().cpu().numpy() for o in outs)
        rest_out = np.concatenate(host) if host else np.zeros((0, len(views), 512), np.float32)
        rois_cat = np.concatenate(rois_all) if rois_all else np.zeros((0, 7, 2), np.int64)
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            np.savez(out_path, rest_out=rest_out, rois=rois_cat)
        return rest_out, rois_cat


def plot_panorama(rest_out: np.ndarray, rois: np.ndarray, sample: int, path: str,
                  n_theta: int = 7, n_phi: int = 12) -> None:
    """The 12x7 matplotlib grid (demo.ipynb cells 5-6), time-trimmed to
    rois[-1,0]-20."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    end = max(int(rois[sample, -1, 0]) - 20, 8)
    waves = rest_out[sample].reshape(n_theta, n_phi, -1)
    fig, axes = plt.subplots(n_phi, n_theta, figsize=(2 * n_theta, 1.2 * n_phi),
                             sharex=True, sharey=True, squeeze=False)
    for i in range(n_theta):
        for j in range(n_phi):
            axes[j][i].plot(waves[i, j, :end], linewidth=0.8)
            axes[j][i].set_xticks([])
            axes[j][i].set_yticks([])
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, format="png", dpi=120)
    plt.close(fig)


def render_full_record(gen: PanoramaGenerator, dataset, record_index: int,
                       views: np.ndarray, rng: np.random.Generator | None = None):
    """Dense panorama over every beat of one record: the beat axis is the
    batch axis. Returns ([n_beats, V, 512] tensor, batch)."""
    from electrocardio_panorama_tpu_torch.data.pipeline import collate

    rng = rng or np.random.default_rng(0)
    n = dataset.num_beats(record_index)
    batch = collate([dataset.get_beat(record_index, b, rng) for b in range(n)])
    return gen.render(batch["data"], batch["input_theta"], batch["rois"], views), batch


# ------------------------------------------------------- from-scratch synthesis
class GaussianLatentPrior:
    """Diagonal Gaussian over (z1, z2_grid) latents, fitted on dataset encodes:
    the latent source for synthesis from scratch (the reference exposes
    gen_ecg but no sampler). Moments are numpy arrays per example position;
    `sample` draws with numpy, so the port and the JAX package sample the same
    latents, bit for bit, from the same prior and seed."""

    def __init__(self, mean_z1, std_z1, mean_z2, std_z2, rois_template):
        self.mean_z1, self.std_z1 = mean_z1, std_z1
        self.mean_z2, self.std_z2 = mean_z2, std_z2
        self.rois_template = rois_template  # [7, 2] representative segmentation

    @classmethod
    def from_latents(cls, z1: np.ndarray, z2: np.ndarray, rois_template):
        eps = 1e-6
        return cls(z1.mean(0), z1.std(0) + eps, z2.mean(0), z2.std(0) + eps, rois_template)

    @classmethod
    @torch.no_grad()
    def fit(cls, model_def, params, loader, max_batches: int = 8):
        """Encode up to `max_batches` batches (phase='gen' latents: z1 and the
        pre-reverse z2 grid) on the params' device and fit the moments."""
        device = next(iter(params.values())).device
        host1, host2, z1s, z2s, rois, pending = [], [], [], [], None, 0
        for bi, batch in enumerate(loader):
            if bi >= max_batches:
                break
            z1, z2 = model_def.encode(
                params, *(torch.as_tensor(batch[k], device=device) for k in ("data", "input_theta", "rois")),
                stop_before_reverse=True)
            # on the device within a bounded window (_DEVICE_ACCUM_BYTES)
            z1s.append(z1)
            z2s.append(z2)
            pending += z1.numel() * z1.element_size() + z2.numel() * z2.element_size()
            if pending >= _DEVICE_ACCUM_BYTES:
                host1.extend(z.cpu().numpy() for z in z1s)
                host2.extend(z.cpu().numpy() for z in z2s)
                z1s, z2s, pending = [], [], 0
            if rois is None:
                rois = batch["rois"][0]
        host1.extend(z.cpu().numpy() for z in z1s)
        host2.extend(z.cpu().numpy() for z in z2s)
        return cls.from_latents(np.concatenate(host1), np.concatenate(host2), rois)

    def sample(self, rng: np.random.Generator, n: int, temperature: float = 1.0):
        z1 = self.mean_z1 + temperature * self.std_z1 * rng.standard_normal((n, *self.mean_z1.shape))
        z2 = self.mean_z2 + temperature * self.std_z2 * rng.standard_normal((n, *self.mean_z2.shape))
        rois = np.broadcast_to(self.rois_template, (n, *self.rois_template.shape))
        return z1.astype(np.float32), z2.astype(np.float32), rois.copy()

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, mean_z1=self.mean_z1, std_z1=self.std_z1,
                 mean_z2=self.mean_z2, std_z2=self.std_z2, rois=self.rois_template)

    @classmethod
    def load(cls, path: str):
        z = np.load(path)
        return cls(z["mean_z1"], z["std_z1"], z["mean_z2"], z["std_z2"], z["rois"])


@torch.no_grad()
def synthesize_from_scratch(model_def, params, bn_state, prior: GaussianLatentPrior,
                            views: np.ndarray, n: int, seed: int = 0,
                            temperature: float = 1.0) -> torch.Tensor:
    """Sample n latents from the prior and decode them under `views` [V, 2]
    through the model's gen_ecg (the eager decode_views; reference gen_ecg,
    model_nefnet.py:196-218), on the params' device. Returns [n, V, 512]."""
    device = next(iter(params.values())).device
    z1, z2, rois = prior.sample(np.random.default_rng(seed), n, temperature=temperature)
    v = np.broadcast_to(np.asarray(views, np.float32)[None], (n, len(views), 2)).copy()
    z1, z2, v, rois = (torch.as_tensor(a, device=device) for a in (z1, z2, v, rois))
    return model_def.gen_ecg(params, bn_state, z1, z2, v, rois)
