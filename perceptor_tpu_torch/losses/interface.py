"""Loss interface (counterpart of perceptor_tpu/losses/interface.py).

A loss is a callable `loss(images) -> scalar tensor`, differentiable in
`images`."""

from __future__ import annotations


class LossInterface:
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError
