"""Program spans on the profiler's clock.

``span(name)`` marks a region of the host's work. Under an active
``torch.profiler.profile`` the region is recorded as a host event of that
name, on the same clock as the profiler's CUDA activity, and nests under
the enclosing span of the same thread. With no profiler active it returns
one shared no-op context, so a span costs the check and nothing else.

There is no flag, environment variable, store or exporter: the profiler
holds the spans and writes them out. To see them, run any entry point
under the profiler and read its trace::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.generate(prompts, 32)
    prof.export_chrome_trace("trace.json")  # chrome://tracing, Perfetto

The spans (every name starts with ``repro_torch.``):

  serve.generate      ``ServeEngine.generate``: one request
  serve.prefill       ``ServeEngine._prefill``: one prefill pass
  serve.decode_step   ``ServeEngine._decode_step``: one decode pass (the
                      ``ContinuousBatcher`` steps through it too)
  serve.decode_capture  a graphed engine's first decode pass: the step
                      run eagerly, then captured as a CUDA graph
  serve.decode_graph  a later decode pass of that engine: one replay of
                      the graph, inside ``serve.decode_step``
  moe.route           ``models.moe``: the router and top-k, and under
                      dispatch='ragged' the sort by expert, the host read
                      of the segment sizes, the gathers and the combine;
                      never over an expert's projections
  moe.expert          ``models.moe``: one expert's three macro calls on
                      its tokens (its segment under dispatch='ragged',
                      every token in the masked loop)
  resnet.forward      ``models.resnet.forward``: one forward
  resnet.im2col       ``models.resnet.im2col``: the pad and the window gather
  engine.quantize     a quantized backend's activation quantizer
  engine.quantize_kernel  inside it, the launch of the quantizer's kernels
                      (``kernels.periphery``) where the engine takes them
  engine.macro        its integer macro matmul: dispatch, the kernel's
                      spec and checks, the launch
  engine.epilogue     its zero-point correction, both scales and the cast
                      back to the activation dtype

A pass's parent is the request (``serve.generate``); the engine's three
spans are the children of the pass, or of ``resnet.forward``, that makes
the macro call, or of the ``moe.expert`` span inside it; ``moe.route``
is a child of the pass. A replayed graph makes no macro call on the host, so a
``serve.decode_graph`` pass has no engine spans.

A span is a plain host op (``_RecordFunctionFast``), not a
``record_function``: the profiler mirrors every ``record_function`` onto
the device's timeline as an annotation over the kernels launched inside
it, which a reader of the device events would take for device work.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` when a profiler is active, else
    the shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
