"""Network passes of a training step, replayed from CUDA graphs.

A NICE-GAN step makes sixteen network passes (each generator four times,
each discriminator four), some 10,000 operations forward and backward,
and Python launches each one: on one H100 the host, not the card, set the
step's pace (62 % of the card idle in a traced step). :class:`GraphedPasses`
records each call site's pass at its first call, its forward as one CUDA
graph and, where autograd will ask for a gradient, its backward as another,
and from then on replays them: two launches a pass, and the same kernels on
the same shapes.

A call site is a key of the caller's (NICE-GAN: the network and how many
times the step has called it), and its graphs hold their own memory: the
inputs are copied into buffers of the site's, and the outputs that a replay
returns are the site's buffers too, overwritten by the site's next replay.
The backward returns the inputs' and parameters' gradients in buffers of the
site's; autograd adds the sites' gradients into ``.grad`` as it adds eager
ones.

A call runs eagerly, in the caller's autocast, where the inputs are not on
a CUDA device, the module is in evaluation mode, or the site was recorded
for another module, input shape, dtype or gradient mode. Recording warms
the pass up three times on a side stream first (cuDNN's plans and the
allocator), with ``torch.autograd.grad``, which leaves ``.grad`` as it is.
The captures are ``thread_local``: the loader's thread launches on its own
stream meanwhile. Autocast runs without its cast cache while a pass is
recorded, as CUDA graphs require.

``replays`` counts the passes replayed, ``recorded`` the sites.
"""
from __future__ import annotations

import copy

import torch
from torch.autograd.function import once_differentiable

#: eager passes before a site's capture
WARMUP = 3


def _signature(module, inputs) -> tuple:
    return (tuple((x.shape, x.dtype, x.requires_grad) for x in inputs),
            torch.is_grad_enabled(), module.training)


def _tuple(out) -> tuple:
    return (out,) if torch.is_tensor(out) else tuple(out)


class _Site:
    """One call site: the forward graph, the backward graph where the pass
    takes a gradient, and their buffers."""

    def __init__(self, module, fn, inputs, amp, grad: bool):
        self.module = module
        self.signature = _signature(module, inputs)
        self.inputs = tuple(x.detach().clone().requires_grad_(
            grad and x.requires_grad) for x in inputs)
        self.params = tuple(p for p in module.parameters()
                            if p.requires_grad) if grad else ()
        wrt = tuple(x for x in self.inputs if x.requires_grad) + self.params
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.set_grad_enabled(grad):
            for _ in range(WARMUP):
                with amp():
                    outs = [o for o in _tuple(fn(*self.inputs))
                            if o.requires_grad]
                if grad:
                    torch.autograd.grad(outs, wrt, [torch.zeros_like(o)
                                                    for o in outs],
                                        allow_unused=True)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, capture_error_mode="thread_local"), \
                torch.set_grad_enabled(grad):
            with amp():
                out = fn(*self.inputs)
        self.single = torch.is_tensor(out)
        self.outs = _tuple(out)
        self.bwd = None
        if grad:
            #: an output's gradient buffer, None where it takes none
            self.grad_outs = tuple(torch.zeros_like(o) if o.requires_grad
                                   else None for o in self.outs)
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                                  capture_error_mode="thread_local"):
                self.grad_wrt = torch.autograd.grad(
                    [o for o in self.outs if o.requires_grad], wrt,
                    [g for g in self.grad_outs if g is not None],
                    allow_unused=True)

    def replay(self, inputs) -> tuple:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.fwd.replay()
        return tuple(o.detach() for o in self.outs)


class _Replay(torch.autograd.Function):
    """A site's forward graph as one autograd node whose backward is the
    site's backward graph."""

    @staticmethod
    def forward(ctx, site, n_inputs, *inputs_and_params):
        ctx.site = site
        return site.replay(inputs_and_params[:n_inputs])

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        site = ctx.site
        for buf, g in zip(site.grad_outs, grads):
            if buf is not None:
                buf.copy_(g)
        site.bwd.replay()
        grad_wrt = iter(site.grad_wrt)
        out = [next(grad_wrt) if x.requires_grad else None
               for x in site.inputs]
        out += [next(grad_wrt) for _ in site.params]
        return (None, None, *(None if g is None else g.detach()
                              for g in out))


class GraphedPasses:
    """The passes of a training step by call site; ``amp`` makes the
    caller's autocast context, ``amp(cache_enabled=False)`` the one a
    capture runs in."""

    def __init__(self, amp):
        self.amp = amp
        self.sites: dict = {}
        self.replays = 0

    @property
    def recorded(self) -> int:
        return len(self.sites)

    def __deepcopy__(self, memo):
        """A copy records its own sites: graphs replay their own memory."""
        return GraphedPasses(copy.deepcopy(self.amp, memo))

    def __call__(self, key, module: torch.nn.Module, fn, *inputs):
        """``fn(*inputs)`` (a tensor or a tuple of them), a pass of
        ``module``'s, at call site ``key``."""
        site = self.sites.get(key)
        if inputs[0].device.type != "cuda" or not module.training or (
                site is not None
                and (site.module is not module
                     or site.signature != _signature(module, inputs))):
            with self.amp():
                return fn(*inputs)
        if site is None:
            grad = torch.is_grad_enabled() and (
                any(x.requires_grad for x in inputs)
                or any(p.requires_grad for p in module.parameters()))
            site = self.sites[key] = _Site(
                module, fn, inputs, lambda: self.amp(cache_enabled=False),
                grad)
        self.replays += 1
        outs = (site.replay(inputs) if site.bwd is None else
                _Replay.apply(site, len(inputs), *inputs, *site.params))
        return outs[0] if site.single else tuple(outs)
