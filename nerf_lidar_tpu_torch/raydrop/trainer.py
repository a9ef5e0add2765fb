"""Ray-drop training loop (counterpart of `nerf_lidar_tpu/raydrop/trainer.py`).

Train a U-Net on [range, semantic, rgb x3, var] 6-channel range images to
predict which rays a real sensor would drop. Losses: CE(mask) +
Gumbel-softmax hard mask x VGG perceptual loss on the masked range (weight
0.2), optional Darknet feature loss (0.5) and range-regression L1. Random
azimuth roll augmentation. Eval on a held-out split every 10 epochs with CE
early stopping. Adam at lr 1e-3 (the update optax's `adam` computes).

Data are numpy arrays in the JAX package's layout (images [N, H, W, C]);
the networks see NCHW tensors on the trainer's device. Random draws come
from explicit generators: the roll shift from a CPU generator, the Gumbel
noise from one on the device; `train_step` also takes both from the
caller, so a step can be replayed on another device or against JAX.

Checkpoints: `raydrop_#####.pt` (weights, BatchNorm buffers, Adam state,
step) and beside it `raydrop_#####.npz`, the U-Net's Flax `params` and
`batch_stats` as a flat '/'-keyed tree that the JAX `UNet` can apply;
`restore` also reads the JAX package's msgpack `raydrop_#####.ckpt`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..utils import msgpack
from . import darknet as dk_lib
from . import vgg as vgg_lib
from .unet import UNet, init_flax_default_


@dataclasses.dataclass(frozen=True)
class RayDropConfig:
    n_channels: int = 6
    n_classes: int = 2
    lr: float = 1e-3  # torch.optim.Adam default used by the reference
    epochs: int = 100
    batch_size: int = 4
    mask_loss: bool = True
    vgg: bool = True
    vgg_weight: float = 0.2
    vgg_npz: Optional[str] = None  # converted torchvision VGG19 weights
    # Darknet (rangenet) multi-scale feature loss
    # (reference ray_drop_train.py:116-122 feature_loss knob).
    darknet: bool = False
    darknet_weight: float = 0.5  # reference ray_drop_train.py:23
    darknet_npz: Optional[str] = None  # converted rangenet backbone weights
    regression: bool = False
    roll: bool = True
    val_fraction: float = 0.2
    eval_every: int = 10
    early_stop: bool = True
    early_stop_patience: int = 2  # non-improving evals before stopping
    gumbel_tau: float = 1.0


@dataclasses.dataclass
class RayDropState:
    step: int
    model: UNet
    optimizer: torch.optim.Optimizer


def gumbel_softmax_hard(logits: torch.Tensor, tau: float = 1.0,
                        dim: int = -1,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
    """Straight-through Gumbel-softmax (hard one-hot forward, soft grads),
    as torch.nn.functional.gumbel_softmax(hard=True) computes it, but with
    the Gumbel noise drawn from `generator` (or given as `noise`)."""
    if noise is None:
        noise = -torch.empty_like(logits).exponential_(
            generator=generator).log()
    y = torch.softmax((logits + noise) / tau, dim=dim)
    idx = y.argmax(dim=dim, keepdim=True)
    hard = torch.zeros_like(y).scatter_(dim, idx, 1.0)
    return hard + y - y.detach()


def to_nchw(images: np.ndarray, device) -> torch.Tensor:
    """[N, H, W, C] numpy -> [N, C, H, W] float32 tensor on `device`."""
    t = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    return t.to(device).permute(0, 3, 1, 2).contiguous()


class RayDropTrainer:
    """Data is a dict of numpy arrays:
      images [N, H, W, C] (channel 0 = normalized simulated range),
      masks [N, H, W] int in {0, 1} (1 = real sensor returned the ray),
      ranges [N, H, W] normalized real range.
    """

    def __init__(self, cfg: RayDropConfig, seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.vgg_model = self.dk_model = None
        if cfg.vgg:
            self.vgg_model = (
                vgg_lib.load_vgg19(cfg.vgg_npz, self.device) if cfg.vgg_npz
                else vgg_lib.init_vgg(torch.Generator().manual_seed(seed + 7),
                                      self.device))
        if cfg.darknet:
            self.dk_model = (
                dk_lib.load_rangenet(cfg.darknet_npz, self.device)
                if cfg.darknet_npz
                else dk_lib.init_darknet(
                    torch.Generator().manual_seed(seed + 13), self.device))
        self.history = []

    def init_state(self, seed: int = 0) -> RayDropState:
        model = UNet(n_channels=self.cfg.n_channels,
                     n_classes=self.cfg.n_classes,
                     regression=self.cfg.regression)
        init_flax_default_(model, torch.Generator().manual_seed(seed))
        return self.make_state(model.to(self.device))

    def make_state(self, model: UNet, step: int = 0) -> RayDropState:
        opt = torch.optim.Adam(model.parameters(), lr=self.cfg.lr,
                               eps=1e-8)
        return RayDropState(step=step, model=model, optimizer=opt)

    def losses(self, model: UNet, img, gt_mask, gt_range, train: bool,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """img [N, C, H, W], gt_mask / gt_range [N, H, W] -> (loss, stats).
        A train-mode call moves the U-Net's BatchNorm statistics."""
        cfg = self.cfg
        model.train(train)
        out = model(img)
        logits, pred_range = (out if cfg.regression else (out, None))
        loss = 0.0
        stats = {}
        if cfg.regression:
            m = (gt_mask == 1).to(img.dtype)
            diff = (pred_range[:, 0] - gt_range).abs() * m
            reg = diff.sum() / torch.clamp(m.sum(), min=1.0)
            loss = loss + reg
            stats["range_l1"] = reg
        if cfg.mask_loss:
            ce = F.cross_entropy(logits, gt_mask.long())
            loss = loss + ce
            stats["ce"] = ce
        if (cfg.vgg or cfg.darknet) and train:
            hard = gumbel_softmax_hard(logits, cfg.gumbel_tau, dim=1,
                                       generator=generator, noise=noise)
            if cfg.vgg:
                masked_range = img[:, 0] * hard[:, 1]
                vloss = vgg_lib.vgg_loss_map(self.vgg_model, masked_range,
                                             gt_range).mean()
                loss = loss + cfg.vgg_weight * vloss
                stats["vgg"] = vloss
            if cfg.darknet:
                dloss = dk_lib.feature_loss(self.dk_model, img[:, 0],
                                            gt_range, hard[:, 1])
                loss = loss + cfg.darknet_weight * dloss
                stats["darknet"] = dloss
        stats["loss"] = loss
        return loss, stats

    def train_step(self, state: RayDropState, img, gt_mask, gt_range,
                   shift: Optional[int] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   noise_generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on a batch (tensors on the device, img NCHW). The
        azimuth roll takes `shift`, else a draw from `generator`; the Gumbel
        noise is `noise` ([N, n_classes, H, W]), else a draw from
        `noise_generator`."""
        if self.cfg.roll:
            if shift is None:
                shift = int(torch.randint(0, img.shape[3], (),
                                          generator=generator))
            img = torch.roll(img, shift, dims=3)
            gt_mask = torch.roll(gt_mask, shift, dims=2)
            gt_range = torch.roll(gt_range, shift, dims=2)
        loss, stats = self.losses(state.model, img, gt_mask, gt_range, True,
                                  noise_generator, noise)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in stats.items()}

    @torch.no_grad()
    def eval_loss(self, state: RayDropState, img, gt_mask) -> torch.Tensor:
        state.model.eval()
        out = state.model(img)
        logits = out[0] if self.cfg.regression else out
        return F.cross_entropy(logits, gt_mask.long())

    def batch(self, images, masks, ranges, idx):
        """Frames `idx` of the data as (img NCHW, masks, ranges) tensors on
        the device."""
        dev = self.device
        return (to_nchw(images[idx], dev),
                torch.from_numpy(np.ascontiguousarray(masks[idx])).to(dev),
                torch.from_numpy(np.ascontiguousarray(
                    ranges[idx], np.float32)).to(dev))

    def fit(self, data: Dict[str, np.ndarray], save_dir: Optional[str] = None,
            seed: int = 0, log_fn=print) -> RayDropState:
        """The JAX `fit`: the same split and batch order (one
        np.random.RandomState(seed)), wrap-around batches, eval every
        `eval_every` epochs, early stop, checkpoints and metrics.json under
        `save_dir`. Appends each epoch's mean stats to `self.history`."""
        cfg = self.cfg
        images, masks, ranges = (data["images"], data["masks"],
                                 data["ranges"])
        n = images.shape[0]
        rng = np.random.RandomState(seed)
        perm = rng.permutation(n)
        n_val = max(1, int(n * cfg.val_fraction)) if n > 1 else 0
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        if len(train_idx) == 0:
            train_idx = perm

        state = self.init_state(seed)
        gen = torch.Generator().manual_seed(seed)
        noise_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        best_val = np.inf
        bad_evals = 0
        bs = cfg.batch_size
        for epoch in range(cfg.epochs + 1):
            rng.shuffle(train_idx)
            ep_stats = []
            for i in range(0, len(train_idx), bs):
                idx = train_idx[i:i + bs]
                if len(idx) < bs:  # keep static shapes: wrap around
                    idx = np.concatenate([idx, train_idx[:bs - len(idx)]])
                stats = self.train_step(
                    state, *self.batch(images, masks, ranges, idx),
                    generator=gen, noise_generator=noise_gen)
                ep_stats.append({k: float(v) for k, v in stats.items()})
            self.history.append(dict(epoch=epoch, steps=len(ep_stats), **{
                k: float(np.mean([s[k] for s in ep_stats]))
                for k in ep_stats[0]}))
            if epoch % cfg.eval_every == 0 and epoch > 0 and n_val > 0:
                val_losses = []
                for i in range(0, len(val_idx), bs):
                    idx = val_idx[i:i + bs]
                    if len(idx) < bs:
                        idx = np.concatenate([idx, val_idx[:bs - len(idx)]])
                    img, msk, _ = self.batch(images, masks, ranges, idx)
                    val_losses.append(float(self.eval_loss(state, img, msk)))
                val = float(np.mean(val_losses))
                self.history[-1]["val_ce"] = val
                log_fn(f"epoch {epoch}: train "
                       f"{self.history[-1]['loss']:.4f} val_ce {val:.4f}")
                if save_dir:
                    self.save(save_dir, state, epoch)
                if cfg.early_stop:
                    if val < best_val:
                        best_val = val
                        bad_evals = 0
                    else:
                        bad_evals += 1
                        if bad_evals >= cfg.early_stop_patience:
                            break
        if save_dir:
            self.save(save_dir, state, state.step)
            # Mask-quality endpoint metrics on the held-out split (train
            # split when n is too small to hold one out).
            ev_idx = val_idx if n_val > 0 else train_idx
            metrics = self.evaluate(state, images[ev_idx], masks[ev_idx],
                                    ranges[ev_idx])
            metrics["split"] = "val" if n_val > 0 else "train"
            with open(os.path.join(save_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=1)
            log_fn("raydrop eval "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()
                              if isinstance(v, float)))
        return state

    def evaluate(self, state: RayDropState, images: np.ndarray,
                 masks: np.ndarray, ranges: np.ndarray,
                 threshold: float = 0.5) -> Dict[str, float]:
        """Drop-mask quality vs the real sensor's GT pattern.

        keep = prob > threshold vs gt keep = mask == 1:
          iou / precision / recall   over the keep class
          pred_keep_rate / gt_keep_rate
          ce                         mean masked cross-entropy (val loss)
          range_mae_gt               |sim_range - gt_range| on GT returns
                                     (simulation fidelity, norm units)
          range_mae_kept             same on true-positive pixels
        """
        tp = fp = fn = 0.0
        ce_sum = 0.0
        pred_keep = gt_keep = total = 0.0
        mae_gt_sum = mae_gt_n = mae_tp_sum = mae_tp_n = 0.0
        for i in range(images.shape[0]):
            prob = self.predict_prob(state, images[i:i + 1])[0]
            keep = prob > threshold
            gt = masks[i] == 1
            tp += float((keep & gt).sum())
            fp += float((keep & ~gt).sum())
            fn += float((~keep & gt).sum())
            pred_keep += float(keep.sum())
            gt_keep += float(gt.sum())
            total += float(gt.size)
            p1 = np.clip(prob, 1e-7, 1 - 1e-7)
            ce_sum += float(-(np.where(gt, np.log(p1),
                                       np.log1p(-p1))).mean())
            diff = np.abs(images[i][..., 0] - ranges[i])
            mae_gt_sum += float(diff[gt].sum())
            mae_gt_n += float(gt.sum())
            tp_pix = keep & gt
            mae_tp_sum += float(diff[tp_pix].sum())
            mae_tp_n += float(tp_pix.sum())
        eps = 1e-9
        return {
            "iou": tp / max(tp + fp + fn, eps),
            "precision": tp / max(tp + fp, eps),
            "recall": tp / max(tp + fn, eps),
            "pred_keep_rate": pred_keep / max(total, eps),
            "gt_keep_rate": gt_keep / max(total, eps),
            "ce": ce_sum / max(images.shape[0], 1),
            "range_mae_gt": mae_gt_sum / max(mae_gt_n, eps),
            "range_mae_kept": mae_tp_sum / max(mae_tp_n, eps),
            "n_frames": int(images.shape[0]),
        }

    @torch.no_grad()
    def predict_prob(self, state: RayDropState,
                     images: np.ndarray) -> np.ndarray:
        """Per-pixel keep probability (softmax channel 1) of [N, H, W, C]
        images, analog of ray_drop_train.py:203-221 `test`."""
        state.model.eval()
        out = state.model(to_nchw(images, self.device))
        if self.cfg.regression:
            out = out[0]
        return torch.softmax(out, dim=1)[:, 1].cpu().numpy()

    def save(self, directory: str, state: RayDropState, tag: int) -> str:
        """Write raydrop_<tag>.pt and its Flax-layout raydrop_<tag>.npz;
        returns the .pt path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"raydrop_{tag:05d}.pt")
        torch.save({"step": state.step,
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, path)
        convert.save_npz_params(path[:-3] + ".npz",
                                convert.unet_to_flax(state.model))
        return path

    def restore(self, path: str) -> RayDropState:
        """A state from a `.pt` checkpoint (weights, buffers, Adam, step),
        a Flax-layout `.npz` (weights and buffers; fresh Adam), or the JAX
        package's msgpack `raydrop_#####.ckpt` (`to_bytes` of its
        `RayDropState`: weights, buffers and step; fresh Adam, since
        optax's state is not carried across)."""
        model = UNet(n_channels=self.cfg.n_channels,
                     n_classes=self.cfg.n_classes,
                     regression=self.cfg.regression)
        if path.endswith(".npz"):
            model.load_state_dict(convert.unet_from_flax(
                convert.load_npz_params(path), model))
            return self.make_state(model.to(self.device))
        if path.endswith(".ckpt"):
            raw = msgpack.read_file(path)
            model.load_state_dict(convert.unet_from_flax(
                {"params": raw["params"],
                 "batch_stats": raw["batch_stats"]}, model))
            return self.make_state(model.to(self.device), int(raw["step"]))
        ck = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(ck["model"])
        state = self.make_state(model.to(self.device), int(ck["step"]))
        state.optimizer.load_state_dict(ck["optimizer"])
        return state
