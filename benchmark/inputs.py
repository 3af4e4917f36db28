"""Everything a cell feeds the model, drawn from the run's ``--seed``.

Both sides take their inputs from here: the program's build
(``bitnet.py``) and the plain reference (``reference.py``). Each draw has
a generator of its own, seeded from ``--seed`` and a tag, so that the
reference can draw one layer again without drawing the layers before it.
Weights are drawn on the device in one large call a layer, in the type
they are served in: ternary int8 for the projections, f32 for the
embedding and the norm scales. Plain PyTorch only: nothing of the program.
"""

from __future__ import annotations

import hashlib

import torch

#: absmean scale of every ternary projection (the JAX serving tool's)
GAMMA = 0.03
#: share of nonzero weights; the signs are balanced
DENSITY = 0.5
#: the order of a block's ternary matrices in its single draw, by name and
#: (rows, columns) as functions of (d, kv width, ff)
MATRICES = (
    ("wqkv", lambda d, kvw, ff: (d, d + 2 * kvw)),
    ("wo", lambda d, kvw, ff: (d, d)),
    ("w_gate", lambda d, kvw, ff: (d, ff)),
    ("w_up", lambda d, kvw, ff: (d, ff)),
    ("w_down", lambda d, kvw, ff: (ff, d)),
)


def sizes(config: dict) -> dict:
    """The model's sizes under short names, from a configuration file's
    published keys."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    kv_heads = config.get("num_key_value_heads", heads)
    hd = d // heads
    return {"d": d, "ff": config["intermediate_size"], "heads": heads,
            "kv_heads": kv_heads, "hd": hd, "kv_width": kv_heads * hd,
            "layers": config["num_hidden_layers"],
            "vocab": config["vocab_size"]}


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's tags
    (any whole number as ``seed``, negative or above 64 bits too)."""
    key = "/".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(seed: int, *tags, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def ternary(u: torch.Tensor, density: float = DENSITY) -> torch.Tensor:
    """int8 in {-1, 0, +1} from uniform draws: +1 below density/2, -1 from
    there to density."""
    half = density / 2
    return (u < half).to(torch.int8) - ((u >= half) & (u < density)).to(
        torch.int8)


def layer_weights(model: dict, seed: int, layer: int, device) -> dict:
    """Block ``layer``'s weights: the ternary ``(K, N)`` matrices of
    :data:`MATRICES` (``y = x @ W``) and the two RMSNorm scales."""
    d, ff, kvw = model["d"], model["ff"], model["kv_width"]
    g = generator(seed, "layer", layer, device=device)
    shapes = [(name, f(d, kvw, ff)) for name, f in MATRICES]
    total = sum(k * n for _, (k, n) in shapes)
    flat = ternary(torch.rand(total, generator=g, device=device))
    out, at = {}, 0
    for name, (k, n) in shapes:
        out[name] = flat[at:at + k * n].view(k, n)
        at += k * n
    norms = 1.0 + 0.1 * torch.randn(2, d, generator=g, device=device)
    out["norm_attn"], out["norm_ffn"] = norms[0], norms[1]
    return out


def embedding(model: dict, seed: int, device) -> torch.Tensor:
    """The tied ``(vocab, d)`` f32 embedding, N(0, 0.02**2)."""
    g = generator(seed, "embed", device=device)
    return 0.02 * torch.randn(model["vocab"], model["d"], generator=g,
                              device=device)


def final_norm(model: dict, seed: int, device) -> torch.Tensor:
    g = generator(seed, "norm_out", device=device)
    return 1.0 + 0.1 * torch.randn(model["d"], generator=g, device=device)


def prompts(model: dict, traffic: dict, seed: int, batch: int,
            device) -> torch.Tensor:
    """Batch ``batch``'s prompts: ``(requests, prompt_len)`` int64 token
    ids, uniform over the vocabulary."""
    g = generator(seed, "prompts", batch, device=device)
    return torch.randint(0, model["vocab"],
                         (traffic["batch"], traffic["prompt_len"]),
                         generator=g, device=device)


class Noise:
    """The sampler's uniform draws, one ``(requests, vocab)`` tensor a
    call, as the port's generate loop asks for them (an object with
    ``fill_``). The draw of batch ``b``'s call ``c`` has a generator of its
    own (:meth:`seek`), so that the check can draw it again. The rows of
    greedy requests are held at 0.5: the Gumbel noise of such a row is one
    constant, so its token is the argmax of its logits, whatever the
    temperature and the nucleus."""

    def __init__(self, seed: int, greedy_rows: int, device):
        self.seed, self.greedy_rows = seed, greedy_rows
        self.gen = torch.Generator(device=device)

    def seek(self, batch: int, call: int) -> None:
        """The next :meth:`fill_` draws batch ``batch``'s call ``call``."""
        self.gen.manual_seed(sub_seed(self.seed, "noise", batch, call))

    def fill_(self, u: torch.Tensor) -> torch.Tensor:
        torch.rand(u.shape, generator=self.gen, out=u)
        if self.greedy_rows:
            u[:self.greedy_rows].fill_(0.5)
        return u

    def draws(self, batch: int, calls: int, requests: int, vocab: int,
              device) -> torch.Tensor:
        """Batch ``batch``'s draws again: ``(requests, calls, vocab)``."""
        u = torch.empty((calls, requests, vocab), device=device)
        for c in range(calls):
            self.seek(batch, c)
            self.fill_(u[c])
        return u.transpose(0, 1)
