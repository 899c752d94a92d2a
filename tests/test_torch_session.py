"""The port's `utils/session.py` on the CPU: a session (drawer parameters,
Adam state, the cutouts' generator, the step) saved and loaded into fresh
objects resumes bit for bit where the uninterrupted run would be, and
`SessionManager` keeps JAX's interval, retention, idempotent-save and
restore semantics, with background writes joined by `wait`."""

import os

import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from perceptor_tpu_torch import drawers, engine, losses, transforms
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.utils import SessionManager, load_session, save_session

TINY = CLIPConfig(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=1,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=1,
    text_heads=2)
SHAPE = (1, 3, 40, 40)


@pytest.fixture(scope="module")
def clip_loss():
    loss = losses.CLIP("ViT-B-32", config=TINY, precision="fp32", device="cpu", seed=7)
    loss.add_encodings_(torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16))
                                         .astype(np.float32)))
    return loss


class Run:
    """A Raw drawer under Adam and a CLIP loss on random cutouts drawn from
    its own generator: everything a session must carry."""

    def __init__(self, clip_loss, init_seed=0, generator_seed=0):
        init = np.random.default_rng(init_seed).random(SHAPE).astype(np.float32)
        self.drawer = drawers.Raw(init, device="cpu")
        self.optimizer = torch.optim.Adam(self.drawer.parameters(), lr=0.05)
        self.generator = torch.Generator().manual_seed(generator_seed)

        def cutout_loss(images):
            return clip_loss(transforms.random_cutouts(images, self.generator, 4, cut_size=32))

        self.step = engine.make_guidance_step(self.drawer, [cutout_loss], self.optimizer)
        self.n = 0

    def run(self, n):
        out = []
        for _ in range(n):
            out.append(self.step()["loss"])
            self.n += 1
        return out

    def state(self):
        return {"params": self.drawer.state_dict(), "opt_state": self.optimizer.state_dict(),
                "generator": self.generator, "step": self.n}

    def restore(self, state):
        self.drawer.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.n = state["step"]


def test_resume_from_disk_is_bitwise_the_uninterrupted_run(clip_loss, tmp_path):
    straight = Run(clip_loss)
    want = straight.run(6)

    first = Run(clip_loss)
    got = first.run(3)
    path = save_session(str(tmp_path / "session.pt"), first.state())
    assert os.path.exists(path)

    resumed = Run(clip_loss, init_seed=1, generator_seed=1)  # other weights, other draws
    state = load_session(path, like=resumed.state())
    assert state["generator"] is resumed.generator and state["step"] == 3
    resumed.restore(state)
    got += resumed.run(3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(resumed.drawer.pixels, straight.drawer.pixels)
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())


def test_load_session_refuses_a_missing_generator(tmp_path):
    path = save_session(str(tmp_path / "s.pt"), {"step": 1, "generator": 0})
    with pytest.raises(ValueError, match="generator"):
        load_session(path, like={"step": 0, "generator": torch.Generator()})


@pytest.mark.parametrize("async_save", [True, False])
def test_session_manager_interval_retention_and_restore(clip_loss, tmp_path, async_save):
    run = Run(clip_loss)
    with SessionManager(str(tmp_path / "ckpt"), max_to_keep=2, save_interval_steps=2,
                        async_save=async_save) as manager:
        saved = []
        for step in range(6):
            assert manager.should_save(step) == (step % 2 == 0)
            saved.append(manager.save(step, run.state()))
            run.run(1)
        manager.wait()
        assert saved == [True, False, True, False, True, False]
        assert manager.all_steps() == [2, 4]  # retention: the newest two
        assert manager.save(4, run.state()) is False  # idempotent on an existing step
        assert manager.save(5, run.state(), force=True) is True
        assert manager.latest_step() == 5
        assert manager.all_steps() == [4, 5]
        assert not manager.reached_preemption(5)

    # resuming from the manager's step 4 is bitwise the uninterrupted run
    straight = Run(clip_loss)
    want = straight.run(6)
    fresh = Run(clip_loss, init_seed=2, generator_seed=2)
    manager = SessionManager(str(tmp_path / "ckpt"), max_to_keep=2, save_interval_steps=2)
    step, state = manager.restore_latest(fresh.state())
    assert step == 5
    fresh.restore(manager.restore(4, fresh.state()))
    assert fresh.n == 4
    assert all(torch.equal(a, b) for a, b in zip(fresh.run(2), want[4:]))
    manager.close()


def test_session_manager_empty_directory(tmp_path):
    manager = SessionManager(str(tmp_path / "empty"))
    assert manager.latest_step() is None and manager.restore_latest({}) is None
    assert manager.should_save(0)
