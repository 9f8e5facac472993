"""The port's deterministic mode (``train.deterministic``,
``train.loop.set_deterministic``) on the CPU: the UNet's resize with its
fixed-order backward against ``F.interpolate``'s at every resize of the
UNet's forward, the mode's refusal to run CUDA without
``CUBLAS_WORKSPACE_CONFIG``, and train steps under
``torch.use_deterministic_algorithms(True)`` that raise nothing and repeat.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvpnet_torch.config import Config, load_config
from mvpnet_torch.entry import TRAIN_CONFIG, train_entry
from mvpnet_torch.models import unet
from mvpnet_torch.train.loop import set_deterministic
from tests.test_torch_train import TINY


def _unet_resizes(hw=(120, 160)) -> list:
    """(channels, in hw, out hw) of every resize in a UNet forward on views
    of ``hw`` (the default config's 120x160), at narrow widths: the spatial
    sizes do not depend on them."""
    cfg = Config().model.unet
    narrow = dict(base_channels=8, stage_channels=(8, 16, 16, 32), stage_blocks=(1, 1, 1, 1),
                  decoder_channels=(16, 16, 8, 8), feature_channels=8, dtype="float32")
    model = unet.UNetResNet34(dataclasses.replace(cfg, **narrow), gen=torch.Generator().manual_seed(0))
    seen = []
    resize = unet._resize_to

    def record(x, size):
        seen.append((x.shape[-1], tuple(x.shape[1:3]), tuple(size)))
        return resize(x, size)

    unet._resize_to = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, *hw, 3))
    finally:
        unet._resize_to = resize
    return seen


RESIZES = _unet_resizes()


def test_unet_resizes_cover_the_decoder():
    assert [r[2] for r in RESIZES] == [(8, 10), (15, 20), (30, 40), (60, 80), (120, 160)]


@pytest.mark.parametrize("channels,hw_in,hw_out", RESIZES)
def test_bilinear_resize_matches_interpolate(channels, hw_in, hw_out):
    """BilinearResize at each resize of the UNet's forward: the forward is
    F.interpolate's bit for bit, the backward (A_h^T g A_w) agrees with
    F.interpolate's to atol 1e-6, rtol 1e-6; the matrices alone give the
    forward to 1e-6."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, channels, *hw_in)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, channels, *hw_out)).astype(np.float32))
    want = F.interpolate(x, size=hw_out, mode="bilinear", align_corners=False)
    (want_grad,) = torch.autograd.grad(want, x, g)
    got = unet.BilinearResize.apply(x, hw_out)
    (got_grad,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_grad.numpy(), want_grad.numpy(), atol=1e-6, rtol=1e-6)
    by_matrix = unet.interp_matrix(hw_in[0], hw_out[0]) @ x.detach() @ unet.interp_matrix(hw_in[1], hw_out[1]).t()
    np.testing.assert_allclose(by_matrix.numpy(), want.detach().numpy(), atol=1e-6)


def test_set_deterministic_needs_the_cublas_workspace(monkeypatch):
    """On CUDA the mode refuses to start without CUBLAS_WORKSPACE_CONFIG,
    naming it, and changes nothing; on the CPU it needs none."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=:4096:8"):
        set_deterministic(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        set_deterministic()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:2")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        set_deterministic()
    assert not torch.are_deterministic_algorithms_enabled()
    try:
        set_deterministic(device="cpu")
        assert torch.are_deterministic_algorithms_enabled() and torch.backends.cudnn.deterministic
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        set_deterministic(False)
    assert not torch.are_deterministic_algorithms_enabled() and not torch.backends.cudnn.deterministic


def _losses(cfg, steps: int) -> list:
    step, (model, optimizer, batches) = train_entry(device="cpu", cfg=cfg)
    try:
        return [float(step()["loss"]) for _ in range(steps)]
    finally:
        batches.close()


@pytest.mark.parametrize("model_name", ["mvpnet_3d", "sem_seg_2d"])
def test_deterministic_train_steps_repeat(model_name):
    """Three train steps of the tiny config (head dropout 0.5, augmentation
    on) under the mode raise nothing, and two runs give equal losses; the
    UNet takes BilinearResize there. One data worker: several hand their
    batches over in the order they finish."""
    extra = ["model.pn2.dropout=0.5", "train.batch_size=2", "data.num_workers=1"]
    if model_name == "sem_seg_2d":
        extra += ["model.name=sem_seg_2d", "data.sampling=frames"]
    cfg = load_config(TRAIN_CONFIG, TINY + extra)
    calls = []
    apply = unet.BilinearResize.apply
    try:
        set_deterministic(device="cpu")
        unet.BilinearResize.apply = lambda *a: calls.append(1) or apply(*a)
        first, second = _losses(cfg, 3), _losses(cfg, 3)
    finally:
        unet.BilinearResize.apply = apply
        set_deterministic(False)
    assert calls and all(np.isfinite(first))
    assert first == second
