"""Faults planted in the program under test, each of which a cell's
comparison has to turn into `correct` false.

Each takes a `monkeypatch` (`pytest.MonkeyPatch`) and replaces one of the
program's methods for as long as it is in force. The CPU tests plant them
at tiny sizes; `benchmark/calibrate.py --fault <name>` plants one at a
cell's own size on the card and prints the readings.
"""

import torch


def unchanged_step(monkeypatch):
    """The sampler's step returns its state unchanged."""
    from perceptor_tpu_torch.predictions.base import PredictionAlgebra

    monkeypatch.setattr(PredictionAlgebra, "step",
                        lambda self, to, eta=0.0, generator=None: self._decode_xs(self.from_xs))


def half_batch(monkeypatch):
    """The UNet runs the first half of its rows and repeats them."""
    from perceptor_tpu_torch.models.stable_diffusion.unet import UNet

    forward = UNet.forward

    def half(self, latents, timesteps, context, **kwargs):
        n = latents.shape[0] // 2
        out = forward(self, latents[:n], timesteps[:n], context[:n], **kwargs)
        return torch.cat([out, out])

    monkeypatch.setattr(UNet, "forward", half)


def altered_latents(monkeypatch):
    """One element of the guided step's output latents altered by 0.5."""
    from perceptor_tpu_torch.guided_step import GuidedStep

    step = GuidedStep.guided_denoise_step

    def altered(self, latents, context):
        out, loss = step(self, latents, context)
        out = out.clone()
        out.view(-1)[7] += 0.5
        return out, loss

    monkeypatch.setattr(GuidedStep, "guided_denoise_step", altered)


def altered_image(monkeypatch):
    """One element of the decoded images altered by 0.5."""
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    decode = StableDiffusion.decode

    def altered(self, latents):
        images = decode(self, latents).contiguous().clone()
        images.view(-1)[11] += 0.5
        return images

    monkeypatch.setattr(StableDiffusion, "decode", altered)


FAULTS = {f.__name__: f for f in (unchanged_step, half_batch, altered_latents, altered_image)}
# the faults each cell can have
CELL_FAULTS = {
    "sd15_clipguided_512_b1": ("unchanged_step", "altered_latents"),
    "sd15_txt2img_512_b8": ("unchanged_step", "half_batch", "altered_image"),
}
