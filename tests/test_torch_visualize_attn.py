"""PyTorch port, cli.visualize_attn against the JAX package's on the CPU:
both CLIs read one reference-named .pth (tests/torch_oracle.py::
make_state_dict, lemevit_micro) and one 64 px PNG, and write the same
files: each meta token's c <- x map and the x <- c entropy map, pixel for
pixel within 1 (the min-max normalised maps rounded to uint8), at a D
block of stage 1 and of stage 2. Also the block-input capture
(models/lemevit.py::capture_block_inputs) against JAX's sow: every
block's (x, c), 1e-5, with the hooks gone and s_stage restored after."""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from lemevit_tpu.cli import visualize_attn as jvis
from lemevit_tpu.data.mixup import normalize as j_normalize
from lemevit_tpu.models import create_model as j_create_model
from lemevit_tpu.train.checkpoint import load_pretrained as j_load
from lemevit_tpu_torch.cli import visualize_attn as pvis
from lemevit_tpu_torch.data.transforms import normalize
from lemevit_tpu_torch.models.lemevit import capture_block_inputs
from lemevit_tpu_torch.models.registry import create_model, variant_config
from lemevit_tpu_torch.train.checkpoint import load_pretrained
from tests import torch_oracle

PX = 64


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("vis")
    cfg = dict(variant_config("lemevit_micro"), num_classes=1000)
    torch.save({"state_dict": torch_oracle.make_state_dict(cfg, seed=4)},
               root / "w.pth")
    rs = np.random.RandomState(0)
    small = rs.randint(0, 256, (8, 8, 3), np.uint8)
    Image.fromarray(small).resize((PX, PX), Image.BILINEAR).save(
        root / "img.png")
    return root


@pytest.mark.parametrize("stage", [1, 2])
def test_visualize_attn_pngs(files, stage):
    common = ["--image", str(files / "img.png"), "--model", "lemevit_micro",
              "--checkpoint", str(files / "w.pth"), "--img-size", str(PX),
              "--stage", str(stage), "--block", "0"]
    jvis.main(common + ["--out", str(files / f"jax{stage}")])
    res = pvis.main(common + ["--device", "cpu",
                              "--out", str(files / f"port{stage}")])
    names = sorted(os.listdir(files / f"jax{stage}"))
    assert names == sorted(os.path.basename(p) for p in res["paths"])
    assert len(names) == variant_config("lemevit_micro")["queries_len"] + 1
    assert res["grid"] == ((16, 16) if stage == 1 else (8, 8))
    for n in names:
        got = np.asarray(Image.open(files / f"port{stage}" / n), np.int16)
        want = np.asarray(Image.open(files / f"jax{stage}" / n), np.int16)
        assert got.shape == want.shape == (PX, PX, 3)
        assert np.abs(got - want).max() <= 1, n
        assert got[..., 0].std() > 0  # a map, not a flat overlay
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])


def test_visualize_attn_refuses_other_stages(files):
    with pytest.raises(SystemExit, match="pick a D stage"):
        pvis.main(["--image", str(files / "img.png"), "--model",
                   "lemevit_micro", "--stage", "3", "--device", "cpu"])


def test_capture_block_inputs(files):
    model = create_model("lemevit_micro", num_classes=1000,
                         device="cpu").eval()
    load_pretrained(model, str(files / "w.pth"))
    jm = j_create_model("lemevit_micro", num_classes=1000,
                        attn_backend="xla")
    v = j_load(jm, str(files / "w.pth"))
    # the CLI runs' input, whose eager JAX ops are compiled by then
    x = np.array(Image.open(files / "img.png").convert("RGB"))[None]
    _, state = jm.apply(v, j_normalize(x), train=False,
                        mutable=["intermediates"])
    want = state["intermediates"]["block_inputs"]
    model.s_stage = True
    with torch.no_grad(), capture_block_inputs(model) as got:
        assert not model.s_stage
        model(normalize(torch.from_numpy(x)))
    assert model.s_stage
    assert len(got) == len(want) == sum(model.depth)
    for (gx, gc), (wx, wc) in zip(got, want):
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                                   atol=1e-5)
    n = len(got)
    with torch.no_grad():
        model(normalize(torch.from_numpy(x)))
    assert len(got) == n  # the hooks are gone
    assert all(not blk._forward_pre_hooks
               for stage in model.stages for blk in stage)
