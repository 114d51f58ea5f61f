"""Serving launcher: batched prefill + greedy decode loop.

The port of the reference's ``launch/serve.py``.  A batch of prompts is
prefilled (building the KV or recurrent cache), then tokens are decoded
greedily (argmax) step by step: ``gen`` tokens, the first from the
prefill's logits.  llava's image tokens sit before the prompt and whisper's
encoder reads its audio frames; both come as stub embeddings (``extra``,
zeros by default, as in the reference).  On the card the attention prefill
runs K13 (non-causal for whisper's encoder and cross-attention) and the
RWKV recurrence K14, in prefill and in every decode step.

  python -m repro_torch.launch.serve --arch rwkv6-1.6b --batch 4 \\
      --prompt-len 1024 --gen 32                    # on the card
  python -m repro_torch.launch.serve --arch whisper-large-v3 --reduced \\
      --device cpu --batch 2 --prompt-len 24 --gen 8
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.configs.specs import extra_specs
from repro_torch.launch import steps as St
from repro_torch.models import model as M

__all__ = ["serve", "main"]


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("serve runs on the card by default and no "
                               "CUDA device is available; pass device='cpu' "
                               "for the plain-PyTorch path")
        device = "cuda"
    return torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _grad_off(params):
    """``requires_grad`` off on ``params``' parameters that have it, for the
    run: ``torch.matmul`` folds a batched product into one GEMM only where
    no operand requires grad, so a train state's model would otherwise
    serve a rounding apart from a serving one."""
    on = [p for p in params.parameters() if p.requires_grad]
    for p in on:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in on:
            p.requires_grad_(True)


def serve(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          seed: int = 0, device=None, params=None, prompts=None,
          extra=None):
    """Greedy serving of ``batch`` prompts of ``prompt_len`` tokens.

    Weights come from ``torch.Generator(device).manual_seed(seed)`` and the
    prompts from one seeded ``seed + 1``, both on the device, unless the
    caller passes ``params`` (an ``M.LM`` on the device) or ``prompts`` (a
    (batch, prompt_len) integer tensor).  ``extra`` holds the modality
    stubs (``configs/specs.extra_specs``: llava's ``img_embeds``, whisper's
    ``audio_embeds``); by default they are zeros of that shape on the
    device, the reference's stubs.  The cache holds ``img_tokens +
    prompt_len + gen`` positions, and step i decodes at position
    ``img_tokens + prompt_len + i``.  ``device`` is the card unless given
    (``"cpu"`` runs the plain versions of the kernels).  A model whose
    parameters require grad (a train state's) serves bitwise as one whose
    do not: that flag is off for the run.

    Returns ``(tokens, stats)``: tokens (batch, gen) int64, and stats with
    ``prefill_s``, ``decode_s``, ``tok_per_s`` (decoded tokens per second
    over the gen - 1 decode steps) and ``logits``, the (batch, gen, vocab)
    float32 logits each token was picked from.
    """
    if gen < 1:
        raise ValueError(f"gen={gen}: serve generates at least one token")
    device = _device(device)
    if params is None:
        params = M.init_params(torch.Generator(device).manual_seed(seed), cfg)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab, (batch, prompt_len), device=device,
            generator=torch.Generator(device).manual_seed(seed + 1))
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts have shape {tuple(prompts.shape)}, "
                         f"expected {(batch, prompt_len)}")
    prompts = prompts.to(device=device, dtype=torch.long)
    if extra is None:
        spec = extra_specs(cfg, batch)
        extra = (None if spec is None else
                 {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                  for k, t in spec.items()})
    offset = cfg.img_tokens or 0
    prefill = St.make_serve_prefill(cfg, max_len=offset + prompt_len + gen)
    step = St.make_serve_step(cfg)

    with _grad_off(params):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompts, extra)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out, picked = [tok], [logits[:, -1]]
        t1 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = step(params, tok, cache, offset + prompt_len + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            picked.append(logits[:, -1])
        _sync(device)
        t_decode = time.perf_counter() - t1
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "logits": torch.stack(picked, dim=1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tokens, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                          gen=args.gen, seed=args.seed, device=args.device)
    print(f"[serve] generated {tuple(tokens.shape)} tokens; "
          f"prefill {stats['prefill_s']:.3f}s, "
          f"decode {stats['decode_s']:.3f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    return tokens, stats


if __name__ == "__main__":
    main()
