"""The int8 post-training-quantized ResNet50, in plain PyTorch.

The configuration's scheme, written out again from its description (the
JAX package's ``models/resnet_int8.py``): eval BatchNorm folded into each
conv; weights symmetric int8 per output channel; activations calibrated on
representative tiles by max |x| (ReLU outputs at zero point -128, the input
symmetric); every epilogue one float32 fma ``clip(round(float32(acc) * m +
z))``, emulated in float64 and rounded once; 3x3 convs padded with -128;
the stem a 7x7/2 conv on symmetric input codes, then a 3x3/2 max-pool; the
dequantized global average pool.

Integer convolutions run as float64 convolutions of the codes, exact below
2**53. ``weight_bits`` 4 gives the control's int4 weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import costs

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize(tiles_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC tiles -> ImageNet-normalized float32 (ToTensor + Normalize)."""
    return ((tiles_u8.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def block_names():
    counts = [0, 0, 0, 0]
    for stage, stride, _, _, _, has_ds in costs.r50_blocks():
        yield f"layer{stage + 1}_{counts[stage]}", stride, has_ds
        counts[stage] += 1


def fold(conv: dict, bn_p: dict, bn_s: dict) -> tuple[np.ndarray, np.ndarray]:
    """Eval BatchNorm folded into the conv before it (eps 1e-5), float64."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    inv = f(bn_p["scale"]) / np.sqrt(f(bn_s["var"]) + 1e-5)
    return f(conv["kernel"]) * inv, f(bn_p["bias"]) - f(bn_s["mean"]) * inv


def fold_all(variables: dict) -> dict:
    p, s = variables["params"], variables["batch_stats"]
    out = {"conv1": fold(p["conv1"], p["bn1"], s["bn1"])}
    for name, _, has_ds in block_names():
        for i in (1, 2, 3):
            out[f"{name}.conv{i}"] = fold(p[name][f"conv{i}"], p[name][f"bn{i}"],
                                          s[name][f"bn{i}"])
        if has_ds:
            out[f"{name}.downsample"] = fold(p[name]["downsample_conv"],
                                             p[name]["downsample_bn"], s[name]["downsample_bn"])
    return out


def quantize(kernel: np.ndarray, bits: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel codes of a float32 HWIO kernel."""
    top = 2 ** (bits - 1) - 1
    k = np.asarray(kernel, np.float32)
    s = np.maximum(np.max(np.abs(k), axis=(0, 1, 2)), 1e-12) / float(top)
    return np.clip(np.round(k / s), -top, top).astype(np.int8), s.astype(np.float32)


def _oihw(kernel: np.ndarray, dev) -> torch.Tensor:
    k = torch.from_numpy(np.asarray(kernel, np.float32).astype(np.float64))
    return k.permute(3, 2, 0, 1).contiguous().to(dev)


def _same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA "SAME" padding of an NCHW tensor."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def calibrate(folded: dict, calib: np.ndarray, dev) -> dict:
    """max |x| at every conv input (and 'input', 'final') of the float
    forward with folded weights, in float64; the stem on bf16-rounded input
    and kernel, as the configuration's calibration runs it."""
    rec = {}

    def bias(b):
        return torch.from_numpy(np.asarray(b, np.float32).astype(np.float64)).to(dev)

    def conv(key, x, stride=1):
        k, b = folded[key]
        w = _oihw(k, dev)
        return F.conv2d(_same(x, w.shape[-1], stride), w, stride=stride) + bias(b).view(1, -1, 1, 1)

    x = torch.from_numpy(np.asarray(calib, np.float32)).to(dev).double()
    rec["input"] = float(x.abs().max())
    k, b = folded["conv1"]
    bf = torch.bfloat16
    out = F.conv2d(x.permute(0, 3, 1, 2).to(bf).double(), _oihw(k, dev).to(bf).double(),
                   stride=2, padding=3)
    out = F.max_pool2d(F.relu(out + bias(b).view(1, -1, 1, 1)), 3, stride=2, padding=1)
    for name, stride, has_ds in block_names():
        idn = out
        rec[f"{name}.conv1"] = float(out.abs().max())
        h = F.relu(conv(f"{name}.conv1", out))
        rec[f"{name}.conv2"] = float(h.abs().max())
        h = F.relu(conv(f"{name}.conv2", h, stride))
        rec[f"{name}.conv3"] = float(h.abs().max())
        h = conv(f"{name}.conv3", h)
        if has_ds:
            idn = conv(f"{name}.downsample", out, stride)
        out = F.relu(h + idn)
    rec["final"] = float(out.abs().max())
    return rec


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


class QResNet50:
    """The quantized network's codes and fma constants (built on ``dev``)."""

    def __init__(self, variables: dict, calib: np.ndarray, dev, weight_bits: int = 8) -> None:
        folded = fold_all(variables)
        rec = calibrate(folded, calib, dev)
        act = lambda key: max(rec[key], 1e-12) / 255.0  # noqa: E731
        plan = list(block_names())
        self.dev = dev
        self.blocks = []
        for i, (name, stride, has_ds) in enumerate(plan):
            s1, s2, s3 = (act(f"{name}.conv{j}") for j in (1, 2, 3))
            s_out = act(f"{plan[i + 1][0]}.conv1") if i + 1 < len(plan) else act("final")

            def qc(key, s_in):
                k, b = folded[key]
                w, sw = quantize(k, weight_bits)
                colsum = w.astype(np.float64).sum(axis=(0, 1, 2))
                zp = (128.0 * s_in * sw.astype(np.float64) * colsum).astype(np.float32)
                return w, s_in * sw.astype(np.float64), np.asarray(b, np.float64) + zp

            w1, k1, b1 = qc(f"{name}.conv1", s1)
            w2, k2, b2 = qc(f"{name}.conv2", s2)
            w3, k3, b3 = qc(f"{name}.conv3", s3)
            z3 = b3 / s_out - 128.0
            blk = {"stride": stride,
                   "w1": self._w(w1), "m1": _f32(k1 / s2), "z1": _f32(b1 / s2 - 128.0),
                   "w2": self._w(w2), "m2": _f32(k2 / s3), "z2": _f32(b2 / s3 - 128.0),
                   "w3": self._w(w3), "m3": _f32(k3 / s_out)}
            if has_ds:
                wd, kd, bd = qc(f"{name}.downsample", s1)
                blk.update(wd=self._w(wd), md=_f32(kd / s_out))
                z3 = z3 + bd / s_out
            else:
                blk["id_mult"] = _f32(np.float64(s1 / s_out))
                z3 = z3 + 128.0 * (s1 / s_out)
            blk["z3"] = _f32(z3)
            self.blocks.append({k: v.to(dev) if torch.is_tensor(v) else v
                                for k, v in blk.items()})
        k, b = folded["conv1"]
        w, sw = quantize(np.asarray(k, np.float32), weight_bits)
        self.s_in = max(rec["input"], 1e-12) / 127.0
        s_b1 = act(f"{plan[0][0]}.conv1")
        self.stem_w = self._w(w)
        self.stem_m = _f32(self.s_in * sw.astype(np.float64) / s_b1).to(dev)
        self.stem_z = _f32(np.asarray(b, np.float64) / s_b1 - 128.0).to(dev)
        self.input_scale = _f32(np.float32(self.s_in)).to(dev)
        self.final_scale = _f32(np.float32(act("final"))).to(dev)

    def _w(self, w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(w.astype(np.float64)).permute(3, 2, 0, 1).contiguous().to(self.dev)

    @staticmethod
    def _rq(acc, m, z):
        y = (acc.float().double() * m.double().view(1, -1, 1, 1)
             + z.double().view(1, -1, 1, 1)).float()
        return torch.clamp(torch.round(y), -128, 127)

    def _block(self, x: torch.Tensor, b: dict) -> torch.Tensor:
        """x: NCHW float64 holding int8 codes."""
        h = self._rq(F.conv2d(x, b["w1"]), b["m1"], b["z1"]).double()
        h = F.pad(h, (1, 1, 1, 1), value=-128.0)
        h = self._rq(F.conv2d(h, b["w2"], stride=b["stride"]), b["m2"], b["z2"]).double()
        acc3 = F.conv2d(h, b["w3"])
        if "wd" in b:
            idn = F.conv2d(x, b["wd"], stride=b["stride"]).float() * b["md"].view(1, -1, 1, 1)
        else:
            idn = x.float() * b["id_mult"]
        t = (acc3.float().double() * b["m3"].double().view(1, -1, 1, 1) + idn.double()).float()
        return torch.clamp(torch.round(t + b["z3"].view(1, -1, 1, 1)), -128, 127).double()

    def features(self, tiles_u8: np.ndarray) -> torch.Tensor:
        """(n, H, W, 3) uint8 tiles -> (n, 2048) float32 features."""
        x = torch.from_numpy(np.ascontiguousarray(tiles_u8)).to(self.dev).float()
        mean, std = (torch.from_numpy(a).to(self.dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x / 255.0 - mean) / std
        xq = torch.clamp(torch.round(x / self.input_scale), -127, 127).double()
        acc = F.conv2d(xq.permute(0, 3, 1, 2), self.stem_w, stride=2, padding=3)
        h = self._rq(acc, self.stem_m, self.stem_z)
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=-128.0), 3, stride=2).double()
        for b in self.blocks:
            h = self._block(h, b)
        count = h.shape[2] * h.shape[3]
        return (h.float().sum(dim=(2, 3)) / count + 128.0) * self.final_scale
