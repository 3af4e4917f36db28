"""The captured generate loop — the port's counterpart of the jitted
``_run`` / ``_run_nofill`` of ``ternary_spgemm_tpu/models/generate.py``
(``:721-760``), which run the prefill and the whole decode scan as one
compiled program.

Run eagerly, a decode step of the A8 serve issues thousands of aten ops
and kernel launches from the host, and the card waits on them (``PERF.md``
§5). Here one setting (batch, prompt length T0, ``max_t``, cache dtype,
prefill or not, sampler, ring cache or not) gets:

* :class:`GenerateLoop`: the KV caches and static buffers (the prompt, the
  current token, the position ``pos`` as a 0-d int64 tensor on the device,
  the uniform noise ``(B, vocab)``, the tokens by position) and two bodies
  over them. ``prefill`` runs the prompt's forward, which fills the caches,
  and writes the token at position T0. ``step`` runs the decode step at
  ``pos`` on ``cur`` (with ``prefill=False``, on the prompt's token while
  ``pos < T0``, as ``_run_nofill``), writes the sampled token at ``pos +
  1`` and ends with ``pos += 1``; a ring cache's slot (``pos %
  window``) and its ``pos_tab`` entry come from ``pos`` on the device, so
  one graph serves every step there too. They run eagerly on any device;
* :class:`CapturedGenerate`: each body warmed up twice on a side stream,
  then captured into a CUDA graph on that stream, the two graphs in one
  memory pool. A generation is then: load the prompt (and zero the caches
  and set ``pos``), one prefill replay, the decode replays, each preceded
  only by a draw of the noise when sampling, and one host sync.

What capture needs of the kernel wrappers: the warm-up runs on the
capture stream, so that the decode body's counters, kept by (device,
stream) (``ops.cuda_kernels.gemv_counters``, which raises if asked to
allocate during a capture), and cuBLAS's workspace exist before the
capture, and the library's kernels are loaded. Scratch comes from the
graph's pool and lives as long as the graph. The graphs of one loop share
its stream's counters: replay them in turn, never two at once. The launch
counts of ``ops.cuda_kernels.launches`` tick while a body is captured and
not when it is replayed; :attr:`CapturedGenerate.launches` keeps each
capture's.
"""

from __future__ import annotations

import collections
import gc
import weakref

import torch

from ternary_spgemm_tpu_torch.models.generate import (
    draw_uniform,
    gumbel_from_uniform,
    init_cache,
    sample,
)
from ternary_spgemm_tpu_torch.ops import cuda_kernels as ck

#: eager runs of a body on the capture stream before it is captured
WARMUP = 2


class GenerateLoop:
    """The static state and the two bodies of one generate setting
    (module docstring), run eagerly."""

    def __init__(self, lm, batch: int, prompt_len: int, max_t: int, *,
                 cache_dtype=torch.float32, ring: bool = False,
                 prefill: bool = True, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, device):
        if not 0 < prompt_len < max_t:
            raise ValueError(f"need 0 < prompt length ({prompt_len}) < "
                             f"max_t ({max_t})")
        dev = torch.device(device)
        self.lm = lm
        self.prefill = prefill
        self.sampler = (temperature, top_k, top_p)
        self.prompt_len, self.max_t = prompt_len, max_t
        self.caches = init_cache(lm.cfg, batch, max_t, cache_dtype, ring=ring,
                                 device=dev)
        long = dict(dtype=torch.long, device=dev)
        self.prompt = torch.zeros((batch, prompt_len), **long)
        self.cur = torch.zeros((batch,), **long)
        self.pos = torch.zeros((), **long)
        # the step at the last cache position, max_t - 1, writes at max_t
        self.tokens = torch.zeros((batch, max_t + 1), **long)
        # filled before each body runs; 0.5 for the warm-ups, which draw none
        self.u = (torch.full((batch, lm.cfg.vocab), 0.5, device=dev)
                  if temperature > 0.0 else None)
        self.calls = {"prefill": self.prefill_body} if prefill else {}
        self.calls["step"] = self.step_body

    def _emit(self, logits: torch.Tensor, at: torch.Tensor) -> None:
        """Sample from ``logits (B, vocab)`` into ``cur`` and into the
        tokens at position ``at`` (a 1-element tensor)."""
        noise = None if self.u is None else gumbel_from_uniform(self.u)
        nxt = sample(logits, noise, *self.sampler)
        self.cur.copy_(nxt)
        self.tokens.index_copy_(1, at, nxt[:, None])

    def prefill_body(self) -> None:
        logits, _ = self.lm.prefill(self.prompt, self.caches)
        self._emit(logits[:, -1], self.pos.view(1))

    def step_body(self) -> None:
        tok = self.cur
        if not self.prefill:
            last = torch.clamp(self.pos, max=self.prompt_len - 1).view(1)
            tok = torch.where(self.pos < self.prompt_len,
                              self.prompt.index_select(1, last)[:, 0], tok)
        logits, _ = self.lm.decode_step(tok, self.caches, self.pos)
        self._emit(logits, (self.pos + 1).view(1))
        self.pos += 1

    def reset(self) -> None:
        """Empty the caches (zeros; a ring's ``pos_tab`` -1) and put ``pos``
        where the first body starts."""
        torch._foreach_zero_([t for c in self.caches
                              for k, t in c.items() if k != "pos_tab"])
        for c in self.caches:
            if "pos_tab" in c:
                c["pos_tab"].fill_(-1)
        self.pos.fill_(self.prompt_len if self.prefill else 0)

    def load(self, prompt: torch.Tensor) -> None:
        """Take a new prompt ``(B, T0)`` and :meth:`reset`."""
        if tuple(prompt.shape) != tuple(self.prompt.shape):
            raise ValueError(f"prompt of shape {tuple(prompt.shape)}; this "
                             f"loop takes {tuple(self.prompt.shape)}")
        self.prompt.copy_(prompt)
        self.reset()

    def call(self, name: str, generator=None) -> None:
        """Run body ``name`` once, after drawing its noise when sampling."""
        if self.u is not None:
            draw_uniform(self.u, generator)
        self.calls[name]()

    @torch.no_grad()
    def run(self, prompt: torch.Tensor, n_new: int,
            generator=None) -> torch.Tensor:
        """The ``n_new`` tokens after ``prompt`` as ``(B, n_new)`` int64:
        the prefill and ``n_new - 1`` steps, or ``T0 + n_new - 1`` steps
        without the prefill."""
        T0 = self.prompt_len
        if not 0 < n_new <= self.max_t - T0:
            raise ValueError(f"{n_new} new tokens after {T0} do not fit "
                             f"max_t = {self.max_t}")
        self.load(prompt)
        if self.prefill:
            self.call("prefill", generator)
        for _ in range(n_new - 1 if self.prefill else T0 + n_new - 1):
            self.call("step", generator)
        out = self.tokens[:, T0:T0 + n_new].clone()
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out


class CapturedGenerate(GenerateLoop):
    """:class:`GenerateLoop` with each body captured into a CUDA graph
    (module docstring). ``launches`` holds, for each body, the
    ``ops.cuda_kernels.launches`` counted while it was captured: the
    kernels one replay launches."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        dev = self.pos.device
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs capture work on the card, not on "
                             f"{dev}")
        self.stream = torch.cuda.Stream(dev)
        self.launches = {}
        self.graphs = {}
        pool = torch.cuda.graph_pool_handle()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        # Python's cycle collector must not run inside a capture: if it
        # frees another CUDA graph there, the graph's destruction is an
        # operation a capturing stream does not permit, and the capture
        # fails. Collect now, and hold it off until the captures are done.
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            for name, body in self.calls.items():
                with torch.no_grad():
                    with torch.cuda.stream(self.stream):
                        for _ in range(WARMUP):
                            self.reset()
                            body()
                    before = collections.Counter(ck.launches)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool,
                                          stream=self.stream):
                        body()
                self.launches[name] = ck.launches - before
                self.graphs[name] = graph
        finally:
            if was_enabled:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        # held, so that a later growth of this stream's counters cannot
        # free the ones the graphs fold through
        self.counters = ck._GEMV_COUNTERS.get((dev, self.stream.cuda_stream))
        self.calls = {name: g.replay for name, g in self.graphs.items()}


def captured(lm, batch: int, prompt_len: int, max_t: int, *, cache_dtype,
             prefill: bool, temperature: float, top_k: int, top_p: float,
             device, ring: bool = False) -> CapturedGenerate:
    """``lm``'s :class:`CapturedGenerate` for these settings, captured at
    the first call and kept in ``lm._captured`` (greedy settings share one
    whatever their top_k and top_p)."""
    if temperature <= 0.0:
        temperature, top_k, top_p = 0.0, 0, 1.0
    key = (torch.device(device), batch, prompt_len, max_t, cache_dtype, ring,
           prefill, float(temperature), int(top_k), float(top_p))
    loop = lm._captured.get(key)
    if loop is None:
        # the loop refers to ``lm`` weakly: ``lm`` holds it, and a cycle
        # would keep the graphs alive until a cycle collection, which may
        # come during another capture
        loop = CapturedGenerate(weakref.proxy(lm), batch, prompt_len, max_t,
                                cache_dtype=cache_dtype, ring=ring,
                                prefill=prefill,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, device=device)
        lm._captured[key] = loop
    return loop
