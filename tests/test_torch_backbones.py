"""The port's other tile backbones against the JAX package's, on the CPU.

Each port module is built from a torch seed with non-trivial BatchNorm
statistics; ``utils/jax_params.variables_from_module`` carries its weights to
the flax tree, whose structure must be the one ``jax.eval_shape`` of the flax
``init`` gives, and ``backbone_state_dict_from_jax`` carries them back exactly.
Then the same numpy inputs go through both:

- the ViT (vit_tiny widths, depth 2, patch 8, a 5 x 5 position grid) at 32
  and 48 px, so that the position embeddings shrink and grow: features within
  1e-4, the last block's attention within 1e-5; the resize alone against
  ``jax.image.resize`` within 1e-5 at 14 x 14 -> 18 x 18 and -> 7 x 9;
- EfficientNet-B0's full topology (standard, behind its GELU projection,
  and widese) at 32 px: features within 1e-4;
- InceptionV3 at 75 px (the least its strides allow) with
  ``transform_input``: features within 1e-4;
- ResNet34 with its classifier options (Linear, NormedLinear, mlp,
  two_branch, the attention branch) and ``return_pyramid`` /
  ``return_spatial``: within 1e-4;
- a train-mode forward (flax's BatchNorm rule) of EfficientNet, in
  float64: outputs within 1e-4 and the new running statistics within 1e-5
  of JAX's ``apply(..., train=True, mutable=["batch_stats"])``;
- ``ImageMILModel(pyramid=True)`` over a ResNet50 into MONAI's
  ``att_trans_pyramid``: logits within 1e-3;
- the converters (EfficientNet standard and widese, DINO ViT, Inception)
  against JAX's on the same state dicts, the torch reference modules of
  ``tests/torch_ref`` as the golden forward; NVIDIA's widese weights do not
  load into the standard B0 in either package (ROADMAP C14).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dino_state_dict, torchvision_efficientnet_state_dict, torchvision_state_dict
from tests.torch_ref.backbones_torch import DinoViT, EfficientNetB0
from transmil_deepgraft_tpu.models import backbones as jbb
from transmil_deepgraft_tpu.models import efficientnet as jeff
from transmil_deepgraft_tpu.models import inception as jinc
from transmil_deepgraft_tpu.models import monai_mil as jmonai
from transmil_deepgraft_tpu.models import resnet as jres
from transmil_deepgraft_tpu.models import vit as jvit
from transmil_deepgraft_tpu.utils import torch_weights as jtw
from transmil_deepgraft_tpu_torch.models import backbones as tbb
from transmil_deepgraft_tpu_torch.models import create_model
from transmil_deepgraft_tpu_torch.models import efficientnet as teff
from transmil_deepgraft_tpu_torch.models import inception as tinc
from transmil_deepgraft_tpu_torch.models import resnet as tres
from transmil_deepgraft_tpu_torch.models import vit as tvit
from transmil_deepgraft_tpu_torch.utils import torch_weights as ttw
from transmil_deepgraft_tpu_torch.utils.jax_params import (
    backbone_state_dict_from_jax,
    head_state_dict_from_jax,
    variables_from_module,
)

FEAT_TOL = 1e-4
STATS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded(make, seed: int):
    """A port module made under ``torch.manual_seed(seed)``, BatchNorm
    running statistics drawn too, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
                m.weight.data.uniform_(0.8, 1.2)
                m.bias.data.normal_(0.0, 0.05)
    return module.eval()


def _carried(module, jmodel, x: np.ndarray, **init_kw) -> dict:
    """The module's weights as flax variables, whose tree must be the flax
    ``init``'s; carried back they are the module's state dict exactly."""
    variables = variables_from_module(module)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x),
                                                **init_kw))
    assert jax.tree.map(np.shape, variables) == jax.tree.map(lambda s: s.shape, dict(shapes))
    back = backbone_state_dict_from_jax(variables)
    own = module.state_dict()
    assert set(back) == set(own)
    assert all(torch.equal(back[k], own[k]) for k in own if not k.endswith("batches_tracked"))
    return variables


def _port(module, x: np.ndarray, **kw) -> np.ndarray:
    with torch.no_grad():
        return module(torch.from_numpy(x), **kw).numpy()


def _x(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- ViT

VIT = {"patch_size": 8, "dim": 192, "depth": 2, "heads": 3, "img_size": 40}


@pytest.fixture(scope="module")
def vit():
    module = _seeded(lambda: tvit.vit_tiny(**{k: v for k, v in VIT.items() if k != "dim"}), 1)
    jmodel = jvit.vit_tiny(**{k: v for k, v in VIT.items() if k != "dim"})
    return module, jmodel, _carried(module, jmodel, _x((1, 32, 32, 3), 0))


@pytest.mark.parametrize("size", [32, 36, 48])
def test_vit_matches_jax(vit, size):
    """Features within 1e-4 and the last block's attention probabilities
    within 1e-5, with the 5 x 5 position grid shrunk to 4 x 4, kept (36 px,
    flax's 'SAME' pad of the patch conv to 40) or grown to 6 x 6."""
    module, jmodel, variables = vit
    x = _x((2, size, size, 3), size)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    np.testing.assert_allclose(_port(module, x), want, atol=FEAT_TOL, rtol=0)
    want_attn = np.asarray(jax.jit(lambda v, x: _jax_last_attention(jmodel, v, x))(variables, x))
    with torch.no_grad():
        attn = module.get_last_selfattention(torch.from_numpy(x)).numpy()
    n = 1 + (-(-size // 8)) ** 2
    assert attn.shape == want_attn.shape == (2, 3, n, n)
    np.testing.assert_allclose(attn, want_attn, atol=STATS_TOL, rtol=0)


def _jax_last_attention(jmodel, variables, x):
    """The flax ViT's last block's attention, from that block's input (the
    output of the block before, captured): JAX's own
    ``get_last_selfattention`` raises (ROADMAP C16)."""
    _, state = jmodel.apply(variables, x, capture_intermediates=True, mutable=["intermediates"])
    last = jmodel.depth - 1
    feat = state["intermediates"][f"block{last - 1}"]["__call__"][0]
    block = jvit.ViTBlock(jmodel.dim, jmodel.heads, jmodel.mlp_ratio)
    return block.apply({"params": variables["params"][f"block{last}"]}, feat,
                       return_attention=True)


def test_jax_get_last_selfattention_raises(vit):
    """ROADMAP C16: the flax ViT's ``get_last_selfattention`` builds named
    submodules outside a compact scope, which flax refuses; the port's
    method gives the probabilities (held above)."""
    _, jmodel, variables = vit
    with pytest.raises(AssertionError):
        jmodel.get_last_selfattention(variables, jnp.zeros((1, 32, 32, 3)))


@pytest.mark.parametrize("grid", [(18, 18), (7, 9)])
def test_pos_embed_resize_matches_jax_image_resize(grid):
    """The bicubic resize of a 14 x 14 x 8 grid, up and down, within 1e-5 of
    ``jax.image.resize`` (torch's antialiased bicubic; without antialias it
    is off by up to 2)."""
    pos = _x((1, 196, 8), 3)
    want = np.asarray(jvit._interpolate_pos_embed(jnp.asarray(pos), *grid, 8))
    got = tvit._interpolate_pos_embed(torch.from_numpy(pos), *grid).numpy()
    assert got.shape == want.shape == (1, grid[0] * grid[1], 8)
    np.testing.assert_allclose(got, want, atol=STATS_TOL, rtol=0)


# ------------------------------------------------------- EfficientNet

@pytest.mark.parametrize("widese", [False, True])
def test_efficientnet_matches_jax(widese):
    """The full B0 topology at 32 px (the 1 x 1 maps of its last stages
    included): features within 1e-4. The standard one as
    create_backbone('efficientnet') builds it, behind Linear(1280, 24) and
    the exact GELU, also in train mode; the widese one bare."""
    if widese:
        module = _seeded(lambda: teff.EfficientNet(widese=True), 2)
        jmodel, dim = jeff.EfficientNet(widese=True), 1280
    else:
        module = _seeded(lambda: tbb.create_backbone("efficientnet", out_features=24)[0], 2)
        jmodel, dim = jbb.create_backbone("efficientnet", out_features=24)
    x = _x((3, 32, 32, 3), 4)
    variables = _carried(module, jmodel, x)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    assert want.shape == (3, dim)
    np.testing.assert_allclose(_port(module, x), want, atol=FEAT_TOL, rtol=0)
    if not widese:  # the same rule in both; one float64 compile is enough
        _train_step_matches(module, jmodel, variables, x[:2])


def _train_step_matches(module, jmodel, variables, x) -> None:
    """One train-mode forward (flax's BatchNorm rule), in float64 on both
    sides: at these toy sizes a BatchNorm over a 1 x 1 map normalizes a
    handful of values, whose float32 statistics cancel badly (on
    InceptionV3 at 75 px JAX's float32 lands 7e-3 from float64, the port's
    1e-3). Output
    within 1e-4, the moved running statistics within 1e-5 of JAX's
    ``apply(..., train=True, mutable=["batch_stats"])``."""
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want, state = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                                        mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        want, state = np.asarray(want), jax.device_get(state["batch_stats"])
    module = copy.deepcopy(module).double().train()
    with torch.no_grad():
        got = module(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=0)
    moved = variables_from_module(module)["batch_stats"]
    flat = dict(jax.tree_util.tree_leaves_with_path(state))
    for path, leaf in jax.tree_util.tree_leaves_with_path(moved):
        np.testing.assert_allclose(leaf, flat[path], atol=STATS_TOL, rtol=0, err_msg=str(path))
    before = jax.tree.leaves(variables["batch_stats"])
    assert any(np.abs(a - b).max() > 1e-4 for a, b in zip(before, jax.tree.leaves(moved)))


# ---------------------------------------------------------- Inception

def test_inception_matches_jax():
    """InceptionV3 at 75 px with transform_input (the rest of the net is
    the same either way): features within 1e-4. Its BatchNorm is the
    EfficientNet's (eps 1e-3, flax's train-mode rule, held above)."""
    module = _seeded(lambda: tinc.InceptionV3(transform_input=True), 4)
    x = _x((2, 75, 75, 3), 6)
    jmodel = jinc.InceptionV3(transform_input=True)
    variables = _carried(module, jmodel, x)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    assert want.shape == (2, 2048)
    np.testing.assert_allclose(_port(module, x), want, atol=FEAT_TOL, rtol=0)


# ----------------------------------------------------------- ResNet34

@pytest.mark.parametrize("options", [
    {}, {"num_classes": 3, "two_branch": True, "attention": True},
    {"num_classes": 3, "normlinear": True, "mlp": True, "two_branch": True}], ids=str)
def test_resnet34_matches_jax(options):
    """ResNet34 at 64 px with the reference's heads and attention branch:
    within 1e-4; in feature mode also the stage pyramid and the last
    stage's spatial map."""
    module = _seeded(lambda: tres.resnet34(**options), 5)
    jmodel = jres.resnet34(**options)
    x = _x((2, 64, 64, 3), 7)
    variables = _carried(module, jmodel, x)
    apply = jax.jit(jmodel.apply, static_argnames=("return_pyramid", "return_spatial"))
    want = apply(variables, x)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    pairs = zip(got, want) if options.get("two_branch") else [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEAT_TOL, rtol=0)
    if options:
        return
    pooled, pyramid = apply(variables, x, return_pyramid=True)
    with torch.no_grad():
        tpooled, tpyramid = module(torch.from_numpy(x), return_pyramid=True)
    assert [p.shape[1] for p in tpyramid] == [64, 128, 256, 512]
    for g, w in zip((tpooled, *tpyramid), (pooled, *pyramid)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEAT_TOL, rtol=0)
    spatial = np.asarray(apply(variables, x, return_spatial=True))
    assert spatial.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(_port(module, x, return_spatial=True), spatial, atol=FEAT_TOL,
                               rtol=0)


# ------------------------------------------------- the pyramid stream

def test_image_mil_pyramid_matches_jax():
    """ImageMILModel(pyramid=True): (1 bag x 5 tiles of 32 px) through a
    ResNet50 in 3 chunks, its four stages' features into MONAI's
    att_trans_pyramid (one encoder block a level): logits and attention
    within 1e-3 of JAX's; its converter agrees with JAX's."""
    x = _x((1, 5, 32, 32, 3), 8)
    head_kw = {"mil_mode": "att_trans_pyramid", "trans_blocks": 1}
    backbone = _seeded(tres.resnet50, 6)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        head = create_model("AttTrans", 2, 2048, device="cpu", **head_kw).eval()
    model = tbb.ImageMILModel(backbone, head, n_chunks=3, pyramid=True).eval()
    jmodel = jbb.ImageMILModel(backbone=jres.resnet50(),
                               head=jmonai.MonaiMIL(n_classes=2, **head_kw), n_chunks=3,
                               pyramid=True)
    bb = variables_from_module(backbone)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x)))
    jhead = ttw.convert_monai_mil_state_dict(head.state_dict(), "att_trans_pyramid")
    assert jax.tree.map(np.shape, jhead["params"]) == jax.tree.map(
        lambda s: s.shape, dict(shapes["params"]["head"]))
    ref = jtw.convert_monai_mil_state_dict(head.state_dict(), "att_trans_pyramid")
    assert jax.tree.map(np.shape, ref) == jax.tree.map(np.shape, jhead)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jhead)))
    back = head_state_dict_from_jax("AttTrans", jhead["params"], 2048)
    assert all(torch.equal(back[k], v) for k, v in head.state_dict().items())
    variables = {"params": {"backbone": bb["params"], "head": jhead["params"]},
                 "batch_stats": {"backbone": bb["batch_stats"]}}
    want, want_attn = jax.jit(lambda v, x: jmodel.apply(v, x, return_attn=True))(variables, x)
    with torch.no_grad():
        got, attn = model(torch.from_numpy(x), return_attn=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=1e-3, rtol=0)


# ---------------------------------------------------------- converters

@pytest.mark.parametrize("widese", [False, True])
def test_efficientnet_converter_matches_jax(widese):
    """torchvision-named EfficientNet-B0 (standard, widese): the port's
    converter gives JAX's tree leaf for leaf, and the port's EfficientNet
    loaded with it (widese) reproduces the torch reference within 1e-4."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        ref = _seeded(lambda: EfficientNetB0(widese=widese), 8)
    sd = ref.state_dict()
    got, want = ttw.convert_efficientnet_state_dict(sd), jtw.convert_efficientnet_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    module = teff.EfficientNet(widese=widese).eval()
    module.load_state_dict(backbone_state_dict_from_jax(got))
    x = _x((2, 32, 32, 3), 9)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(_port(module, x), expected, atol=FEAT_TOL, rtol=0)
    named = torchvision_efficientnet_state_dict(module)  # chip_smoke's inverse, for its .pth
    assert set(named) == set(sd) and all(torch.equal(named[k], v) for k, v in sd.items())


def test_widese_weights_do_not_fit_the_efficientnet_backbone():
    """ROADMAP C14: create_backbone('efficientnet') is the standard B0 in
    both packages, so NVIDIA's widese weights (other SE widths) do not load:
    flax refuses the shapes at apply, the port when the weights load."""
    sd = EfficientNetB0(widese=True).state_dict()
    jmodel, _ = jbb.create_backbone("efficientnet", out_features=8)
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.key(0)}, x))
    init = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    conv = jtw.convert_efficientnet_state_dict(sd)
    variables = {"params": {**init["params"], "backbone": conv["params"]},
                 "batch_stats": {"backbone": conv["batch_stats"]}}
    with pytest.raises(Exception, match="ScopeParamShapeError|expected to generate shape"):
        jmodel.apply(variables, x)
    backbone, _ = tbb.create_backbone("efficientnet", out_features=8)
    with pytest.raises(ValueError, match="C14"):
        tbb.load_backbone_variables(backbone, ttw.convert_efficientnet_state_dict(sd))


def test_vit_converter_matches_jax():
    """DINO/timm-named ViT: the port's converter gives JAX's tree, and the
    port's ViT loaded with it reproduces the torch reference within 1e-5."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        ref = DinoViT(img_size=32, patch=8, dim=64, depth=2, heads=2).eval()
    sd = ref.state_dict()
    got, want = ttw.convert_vit_state_dict(sd), jtw.convert_vit_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    module = tvit.VisionTransformer(patch_size=8, dim=64, depth=2, heads=2, img_size=32).eval()
    module.load_state_dict(backbone_state_dict_from_jax(got))
    x = _x((2, 32, 32, 3), 10)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(_port(module, x), expected, atol=STATS_TOL, rtol=0)
    named = dino_state_dict(module)  # chip_smoke's inverse, for its .pth
    assert set(named) == set(sd) and all(torch.equal(named[k], v) for k, v in sd.items())


def test_inception_converter_matches_jax():
    """A seeded state dict in torchvision's Inception-v3 names (an
    AuxLogits key and ``num_batches_tracked`` included, both skipped): the
    port's converter gives JAX's tree, which loads into the port's
    InceptionV3 as the same weights."""
    module = _seeded(lambda: tinc.InceptionV3(num_classes=5), 10)
    sd = dict(module.state_dict())
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    got, want = ttw.convert_inception_state_dict(sd), jtw.convert_inception_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    back = backbone_state_dict_from_jax(got)
    assert all(torch.equal(back[k], v) for k, v in module.state_dict().items())


def test_resnet34_converter_and_image_backbone_loader(tmp_path):
    """ResNet34 through convert_resnet_state_dict, and the images variant's
    loader converts each backbone's .pth by its name."""
    module = _seeded(tres.resnet34, 11)
    sd = torchvision_state_dict(variables_from_module(module))
    assert "layer2.0.downsample.0.weight" in sd
    got = ttw.convert_resnet_state_dict(sd)
    back = backbone_state_dict_from_jax(got)
    assert all(torch.equal(back[k], v) for k, v in module.state_dict().items())
    torch.save(DinoViT(img_size=32, patch=8, dim=64, depth=1, heads=2).state_dict(),
               tmp_path / "dino.pth")
    loaded = ttw.load_image_backbone_variables(tmp_path / "dino.pth", "dino")
    assert set(loaded["params"]) == {"cls_token", "pos_embed", "patch_embed", "norm", "block0"}
    with pytest.raises(ValueError, match="no torch converter"):
        ttw.load_image_backbone_variables(tmp_path / "dino.pth", "simple")
