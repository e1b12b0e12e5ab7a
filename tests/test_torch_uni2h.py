"""UNI2-h (``models/vit.uni2_h``) against its plain reference
(``tests/torch_ref/uni2h_torch.py``) at small widths on the CPU: dim 64, 4
heads, depth 2, 2 register tokens, patch 8 at 32 x 32, packed SwiGLU hidden
128, LayerScale gammas 1 + 0.1 N (at timm's 1e-5 init every branch would be
scaled away and no check could see a fault in it).

The port loads the reference's ``state_dict()``, which is in timm's names,
through ``utils/torch_weights.convert_timm_vit_state_dict``; the slide
pipeline and ``cli.infer --backbone uni2_h`` are held to the reference's
features through the plain TransMIL of ``portbench/reference/transmil``
(with the DeepGraft fc1 of 64-d features, one Linear to 512)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

from portbench import weights_vit
from portbench.reference.transmil_fc1 import Fc1Head
from tests.torch_ref import uni2h_torch as ref
from transmil_deepgraft_tpu_torch.cli import infer
from transmil_deepgraft_tpu_torch.inference import SlideInferencePipeline, decode_tile_paths
from transmil_deepgraft_tpu_torch.models import backbones, vit
from transmil_deepgraft_tpu_torch.serving import head_from_params
from transmil_deepgraft_tpu_torch.utils import profiling
from transmil_deepgraft_tpu_torch.utils.jax_params import state_dict_from_jax
from transmil_deepgraft_tpu_torch.utils.torch_weights import convert_timm_vit_state_dict

SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, mlp_ratio=2.0,
             reg_tokens=2, init_values=1.0)
# float32 against float32: the same operations in another grouping
F32_TOL = 1e-5
# bf16 keeps 8 significant bits (a relative step of 2^-8 = 3.9e-3 at worst);
# the patch embed's and each block's five products round their operands and
# results to it, so the cls feature moves by a few such steps: 2e-2 is five.
# The reference's fp8 products (3 bits) read 4e-2 on this model.
BF16_TOL = 2e-2
PROB_TOL = 1e-5
N_TILES, CHUNK = 10, 4  # 3 chunks, the last one ragged (2 of 4)


def small_uni2h(**kw) -> vit.VisionTransformer:
    return vit.uni2_h(**{"patch_size": 8, "dim": 64, "depth": 2, "heads": 4, "mlp_ratio": 2.0,
                         "reg_tokens": 2, "img_size": 32, **kw})


def seeded_reference(seed: int) -> ref.UNI2h:
    """The small reference with every parameter drawn from ``seed``: Linear
    and conv weights fan-in scaled, biases and LayerNorm shifts 0.1 N,
    LayerNorm scales and gammas 1 + 0.1 N, tokens and positions 0.2 N."""
    g = torch.Generator().manual_seed(seed)
    model = ref.UNI2h(**SMALL)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=g)
            if name.endswith("gamma") or (name.endswith("weight") and p.ndim == 1):
                p.copy_(1 + 0.1 * draw)
            elif p.ndim == 1:
                p.copy_(0.1 * draw)
            elif name.endswith("weight"):
                p.copy_(draw / np.sqrt(p[0].numel()))
            else:
                p.copy_(0.2 * draw)
    return model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """(the reference, the port loaded from its timm-named state dict)."""
    reference = seeded_reference(7)
    port = small_uni2h().eval()
    backbones.load_backbone_variables(port, convert_timm_vit_state_dict(reference.state_dict()))
    return reference, port


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst tile's relative feature gap."""
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@pytest.mark.parametrize("hw", [32, 48], ids=["own-grid", "resized-grid"])
def test_port_matches_the_reference_in_float32(models, hw):
    reference, port = models
    x = torch.randn(3, hw, hw, 3, generator=torch.Generator().manual_seed(hw))
    with torch.no_grad():
        got = port(x)
    want = ref.forward_features(reference, x.permute(0, 3, 1, 2))
    assert got.shape == (3, 64) and got.dtype == torch.float32
    # the features hold no view of the sequence's tokens (a slide's chunks
    # would keep every chunk's tokens alive until the head)
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    assert gap(got, want) <= F32_TOL


def test_bf16_matmuls_keep_a_float32_stream_within_bf16_rounding(models):
    reference, _ = models
    port = small_uni2h().eval()
    backbones.load_backbone_variables(port, convert_timm_vit_state_dict(reference.state_dict()))
    port.cast_matmuls(torch.bfloat16)
    block = port.block0
    assert block.qkv.weight.dtype == block.fc2.bias.dtype == torch.bfloat16
    assert block.norm1.weight.dtype == block.ls2.gamma.dtype == port.pos_embed.dtype \
        == torch.float32
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        stream = port.tokens(x)
        got = port(x)
    assert stream.dtype == got.dtype == torch.float32
    want = ref.forward_features(reference, x.permute(0, 3, 1, 2))
    assert 0 < gap(got, want) <= BF16_TOL
    assert gap(ref.forward_features(reference, x.permute(0, 3, 1, 2), gemm="fp8"), want) \
        > BF16_TOL


def test_the_swiglu_halves_and_the_registers_matter(models):
    """A swapped SwiGLU half order or dropped register tokens move the
    features far beyond the float32 tolerance."""
    reference, port = models
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    want = ref.forward_features(reference, x.permute(0, 3, 1, 2))
    swapped = small_uni2h().eval()
    sd = reference.state_dict()
    for i in range(2):
        w, b = sd[f"blocks.{i}.mlp.fc1.weight"], sd[f"blocks.{i}.mlp.fc1.bias"]
        sd[f"blocks.{i}.mlp.fc1.weight"] = torch.cat(w.chunk(2)[::-1])
        sd[f"blocks.{i}.mlp.fc1.bias"] = torch.cat(b.chunk(2)[::-1])
    backbones.load_backbone_variables(swapped, convert_timm_vit_state_dict(sd))
    no_regs = small_uni2h(reg_tokens=0, no_embed_class=True).eval()
    variables = convert_timm_vit_state_dict(reference.state_dict())
    del variables["params"]["reg_token"]
    backbones.load_backbone_variables(no_regs, variables)
    with torch.no_grad():
        assert gap(port(x), want) <= F32_TOL
        assert gap(swapped(x), want) > 100 * F32_TOL
        assert gap(no_regs(x), want) > 100 * F32_TOL


def test_uni2h_has_the_model_cards_widths():
    with torch.device("meta"):
        model = vit.uni2_h()
    assert sum(p.numel() for p in model.parameters()) == 681_394_176
    blk = model.block23
    assert model.reg_token.shape == (1, 8, 1536) and model.pos_embed.shape == (1, 256, 1536)
    assert blk.fc1.weight.shape == (8192, 1536) and blk.fc2.weight.shape == (1536, 4096)
    assert blk.heads == 24 and model.patch_embed.kernel_size == (14, 14)
    assert backbones.BACKBONE_DIMS["uni2_h"] == 1536


@pytest.mark.parametrize("edit,named", [
    (lambda sd: sd.pop("reg_token"), "reg_token"),
    (lambda sd: sd.pop("blocks.1.mlp.fc2.bias"), "blocks.1.mlp.fc2.bias"),
    (lambda sd: sd.update({"blocks.0.ls1.gamma": torch.ones(63)}), "blocks.0.ls1.gamma"),
    (lambda sd: sd.update({"pos_embed": torch.zeros(1, 16, 32)}), "pos_embed"),
], ids=["no-reg_token", "no-fc2-bias", "misshaped-gamma", "misshaped-pos_embed"])
def test_the_timm_converter_names_a_missing_or_misshaped_key(models, edit, named):
    sd = dict(models[0].state_dict())
    edit(sd)
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        convert_timm_vit_state_dict(sd)


@pytest.fixture(scope="module")
def head_params():
    return weights_vit.transmil_params(5, torch.device("cpu"), in_features=64, n_classes=2)


def reference_probs(reference, head_params, tiles_u8: np.ndarray) -> np.ndarray:
    """The slide's probabilities from the reference's features through the
    plain float32 TransMIL."""
    feats = ref.forward_features(reference, ref.normalize(torch.from_numpy(tiles_u8)))
    logits = Fc1Head(_torch_tree(head_params), "float32")(feats[None])[0].double()
    return torch.softmax(logits, dim=-1).numpy()


def _torch_tree(tree: dict) -> dict:
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_the_slide_pipeline_embeds_through_the_vit(models, head_params):
    reference, port = models
    tiles = np.random.default_rng(4).integers(0, 256, (N_TILES, 32, 32, 3), dtype=np.uint8)
    head = head_from_params("TransMIL", head_params, 64, device="cpu")
    pipe = SlideInferencePipeline(None, head, backbone=port, chunk=CHUNK, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        feats = pipe.embed_device(tiles)
        probs = pipe.predict_slide(tiles)
    counted = profiling.snapshot()
    want = ref.forward_features(reference, ref.normalize(torch.from_numpy(tiles)))
    assert feats.shape == (N_TILES, 64) and gap(feats, want) <= F32_TOL
    np.testing.assert_allclose(probs, reference_probs(reference, head_params, tiles),
                               atol=PROB_TOL, rtol=0)
    # two embeds of 3 chunks, each with 2 zero tiles in its last
    spans = counted["spans"]
    assert spans["backbone.vit"]["calls"] == 6
    assert spans["vit.attn"]["calls"] == spans["vit.mlp"]["calls"] == 12
    assert counted["counters"]["backbone.vit_pad_tiles"] == 4
    _, attn = pipe.predict_slide_with_attention(tiles)
    assert attn.shape == (N_TILES,)


def test_the_slide_pipeline_keeps_int8_for_the_resnet(models, head_params):
    head = head_from_params("TransMIL", head_params, 64, device="cpu")
    with pytest.raises(ValueError, match="ResNet50"):
        SlideInferencePipeline(None, head, backbone=models[1], device="cpu",
                               calib_tiles=np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(TypeError, match="VisionTransformer"):
        SlideInferencePipeline(None, head, backbone=torch.nn.Identity(), device="cpu")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, models, head_params):
    """UNI2-h's timm-named .pth, a TransMIL .pth on 64-d features, and two
    slides of 5 JPEG tiles of 32 x 32 named tile_(x-y).jpg."""
    root = tmp_path_factory.mktemp("uni2h")
    torch.save(models[0].state_dict(), root / "uni2h.pth")
    torch.save(state_dict_from_jax(head_params, 64), root / "head.pth")
    rng = np.random.default_rng(8)
    for s, slide in enumerate(("slideA", "slideB")):
        d = root / "tiles" / slide
        d.mkdir(parents=True)
        for t in range(5):
            arr = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"tile_({t}-{s}).jpg", quality=90)
    return root


def _args(root, *extra):
    return ["--tiles_root", str(root / "tiles"), "--backbone", "uni2_h",
            "--backbone_ckpt", str(root / "uni2h.pth"), "--head_ckpt", str(root / "head.pth"),
            "--in_features", "64", "--chunk", "4", "--tile_size", "32", "--topk", "3",
            "--out_dir", str(root / "out"), "--device", "cpu", *extra]


def test_cli_infer_runs_uni2h_end_to_end(checkpoints, models, head_params, monkeypatch, capsys):
    monkeypatch.setattr(backbones, "uni2_h", small_uni2h)
    root = checkpoints
    got = infer.main(_args(root))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["slides"] == 2
    saved = json.loads((root / "out" / "predictions.json").read_text())
    assert [r["slide"] for r in got] == [r["slide"] for r in saved] == ["slideA", "slideB"]
    for r in got:
        paths = sorted((root / "tiles" / r["slide"]).glob("*.jpg"))
        want = reference_probs(models[0], head_params, decode_tile_paths(paths, 32))
        np.testing.assert_allclose(r["probs"], want, atol=PROB_TOL, rtol=0)
        assert r["n_tiles"] == 5


def test_cli_infer_refuses_int8_for_uni2h(checkpoints):
    with pytest.raises(SystemExit, match="bf16"):
        infer.main(_args(checkpoints, "--quantize", "int8"))
