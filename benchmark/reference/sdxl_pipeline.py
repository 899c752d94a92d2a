"""The reference of Stable Diffusion XL text to image, over the plain
networks in float32 (or, for the control, with every linear and
convolution computed as fp8 products, `layers.set_fp8`, and the sampler's
arithmetic in bfloat16), after diffusers' `StableDiffusionXLPipeline`:

- both text towers read at their penultimate layer (`hidden_states[-2]`,
  no final LayerNorm), their states joined on the width; the second
  tower's end-of-text state (the largest id of each row) after its final
  LayerNorm, through `text_projection`, is the pooled embedding;
- the size ids (H, W, 0, 0, H, W): original size, crop corner and target
  size, the same for both halves of classifier-free guidance;
- the unconditional half all zeros, states and pooled embedding
  (`force_zeros_for_empty_prompt`, no negative prompt);
- one batched UNet call of both halves, the CFG combination, the VAE
  decode at the configuration's `scaling_factor`.

Where it departs from diffusers, it follows the program under test, as
the configuration's `assumed` states: the DDIM update over the port's
rho-spaced index schedule in place of the Euler "leading" scheduler, and
prompts padded with id 0 for both towers (SDXL's first tokenizer pads with
<|endoftext|>, 49407). It imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.clip import CLIPTextModel
from benchmark.reference.layers import Linear, build, causal_mask, full_precision
from benchmark.reference.pipelines import Txt2ImgReference, _Schedule, decode
from benchmark.reference.sd_vae import AutoencoderKL
from benchmark.reference.sdxl_unet import SDXLUNet
from benchmark.reference.tokenizer import BPETokenizer, tokenize


class CLIPTextModelWithProjection(CLIPTextModel):
    """HF `CLIPTextModel` or, where the configuration's `architectures`
    names it, `CLIPTextModelWithProjection` (`text_projection`, a linear
    without bias), returning (penultimate hidden states, pooled projection
    or None)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        if cfg["architectures"] == ["CLIPTextModelWithProjection"]:
            self.text_projection = Linear(cfg["hidden_size"], cfg["projection_dim"], bias=False)

    def forward(self, tokens: torch.Tensor):
        m = self.text_model
        seq = tokens.shape[1]
        x = m.embeddings.token_embedding(tokens) + m.embeddings.position_embedding.weight[:seq]
        mask = causal_mask(seq, tokens.device)
        hidden = [x]
        for layer in m.encoder.layers:
            x = layer(x, mask)
            hidden.append(x)
        if not hasattr(self, "text_projection"):
            return hidden[-2], None
        last = m.final_layer_norm(x)
        pooled = last[torch.arange(last.shape[0], device=last.device), tokens.argmax(dim=-1)]
        return hidden[-2], self.text_projection(pooled)


PARTS = {"unet": SDXLUNet, "vae": AutoencoderKL, "text_encoder": CLIPTextModelWithProjection,
         "text_encoder_2": CLIPTextModelWithProjection}


class Txt2ImgXLReference(Txt2ImgReference):
    def __init__(self, cfg: dict, states: dict, device, fp8: bool = False):
        full_precision()
        _Schedule.__init__(self, cfg, device)
        self.cfg = cfg
        self.device = device
        for part, cls in PARTS.items():
            setattr(self, part, build(cls, cfg[part], states[part], fp8))
        self.update_dtype = torch.bfloat16 if fp8 else torch.float32
        self.tokenizer = BPETokenizer()

    def encode(self, texts):
        """(states (N, 77, width + width_2), pooled (N, projection_dim))."""
        text = self.cfg["text_encoder"]
        tokens = torch.as_tensor(
            tokenize(self.tokenizer, texts, text["max_position_embeddings"], text["pad_id"]),
            device=self.device)
        states, _ = self.text_encoder(tokens)
        states_2, pooled = self.text_encoder_2(tokens)
        return torch.cat([states, states_2], dim=-1), pooled

    def conditioning2(self, prompts, size: int):
        """(context2, pooled2, size ids2): zeros for the unconditional half,
        then the prompts'."""
        context, pooled = self.encode(list(prompts))
        ids = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32,
                           device=self.device).expand(2 * len(prompts), 6)
        return (torch.cat([torch.zeros_like(context), context]),
                torch.cat([torch.zeros_like(pooled), pooled]), ids)

    def unet_out(self, latents, index: int, cond2) -> torch.Tensor:
        """The UNet's noise for the batch of CFG: `latents` twice, under
        `cond2` = (context2, pooled2, size ids2)."""
        t = torch.full((2 * latents.shape[0],), float(index), device=latents.device)
        context2, pooled2, ids2 = cond2
        return self.unet(torch.cat([latents, latents]).float(), t, context2, pooled2, ids2)

    def sample(self, prompts, generator_seed: int, mix: dict) -> dict:
        """One call in the program's place: a record as the driver keeps
        them."""
        n = len(prompts)
        cond2 = self.conditioning2(prompts, mix["size"])
        x = self.initial_latents(n, mix["size"], generator_seed)
        latents, ts, unet_outs = [], [], []
        for i, j in self.pairs(mix["steps"], mix["rho"]):
            latents.append(x)
            ts.append(torch.full((2 * n,), float(i), device=x.device))
            unet_outs.append(self.unet_out(x, int(i), cond2))
            x = self.update(x, unet_outs[-1], int(i), int(j), mix["guidance_scale"],
                            self.update_dtype).float()
        return {"prompts": list(prompts), "generator_seed": generator_seed,
                "context2": cond2[0], "pooled2": cond2[1], "size_ids2": cond2[2],
                "latents": latents, "ts": ts, "unet_out": unet_outs, "final_latents": x,
                "images": decode(self.vae, x)}
