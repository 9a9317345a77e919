"""Taps on the serving path, for holding a forward on a mesh against the
one-device forward (`chip_smoke.py` phase 18 on the card, the ranks of
`tests/test_torch_lm_mesh.py` on the CPU).

`Taps` patches `models.lm.forward`, `models.lm.apply_block`, the two
attention kernels' ops, the decode merge (`attention.merge_partials`)
and the SSD scan for the length of a `with` block, and records what
they saw: every forward's logits, each op's operand shapes, the first
(o, lse) decode call's operands, the merge's collectives
(`launch.comm_stats.CollectiveRecorder`).  With `feed` each layer call
is given another run's input for that call (on a mesh, this rank's
shard of it, as `sharding.axes.local_part` cuts it), so that a chaotic
random-weight model is compared layer by layer rather than after its
rounding differences have grown; `on_layer` sees each layer call's
input and output.  `serve` runs a prefill and decode steps through the
serving steps (`launch.steps`).
"""
from __future__ import annotations

import time


class Taps:
    """For a run: `logits` (every forward's, as returned), `flash` ((q,
    k) shapes), `decode` ((q, k) shapes, the (o, lse) form or not),
    `ssd` (x shapes), `merge` ((o shape, collective records)),
    `decode_call` (the first (o, lse) decode call's operands, cloned) and
    `layers` (what `on_layer(i, h, out)` returned for layer call i, given
    its input h and output; nothing without `on_layer`).  `feed[i]`, a
    whole tensor, replaces layer call i's input (this rank's shard of it
    where the input is a DTensor on `mesh`)."""

    def __init__(self, mesh=None, feed=None, on_layer=None):
        self.mesh, self.feed, self.on_layer = mesh, feed, on_layer
        self.logits, self.flash, self.decode, self.ssd = [], [], [], []
        self.merge, self.layers = [], []
        self.decode_call = None
        self._calls = 0

    def __enter__(self):
        from repro_torch.launch.comm_stats import CollectiveRecorder
        from repro_torch.models import attention as A
        from repro_torch.models import lm
        from repro_torch.models import ssd as S
        self._saved = [(m, n, getattr(m, n)) for m, n in (
            (A, "_flash_op"), (A, "_decode_op"), (A, "merge_partials"),
            (S, "ssd_scan"), (lm, "forward"), (lm, "apply_block"))]
        flash, dec, merge, scan, fwd, block = (f for _, _, f in self._saved)

        def flash_op(q, k, v, **kw):
            self.flash.append((tuple(q.shape), tuple(k.shape)))
            return flash(q, k, v, **kw)

        def decode_op(q, k, v, clen, **kw):
            lse = kw.get("with_lse", False)
            self.decode.append((tuple(q.shape), tuple(k.shape), lse))
            if lse and self.decode_call is None:
                self.decode_call = tuple(t.clone() for t in (q, k, v, clen))
            return dec(q, k, v, clen, **kw)

        def merge_op(o, lse, reduce):
            with CollectiveRecorder() as rec:
                out = merge(o, lse, reduce)
            self.merge.append((tuple(o.shape), rec.records))
            return out

        def ssd_op(x, *a, **kw):
            self.ssd.append(tuple(x.shape))
            return scan(x, *a, **kw)

        def forward(*a, **kw):
            out = fwd(*a, **kw)
            self.logits.append(out[0])
            return out

        def apply_block(blk, h, cfg, **kw):
            i = self._calls
            self._calls += 1
            if self.feed is not None:
                h = self._fed(self.feed[i], h)
            out = block(blk, h, cfg, **kw)
            if self.on_layer is not None:
                self.layers.append(self.on_layer(i, h, out[0]))
            return out

        A._flash_op, A._decode_op, A.merge_partials = \
            flash_op, decode_op, merge_op
        S.ssd_scan, lm.forward, lm.apply_block = ssd_op, forward, apply_block
        return self

    def _fed(self, whole, h):
        from repro_torch.sharding.axes import from_local, is_dtensor, \
            local_part
        whole = whole.to(h.device)
        if not is_dtensor(h):
            return whole
        pl = h.placements
        return from_local(local_part(whole, pl, self.mesh).contiguous(), pl,
                          self.mesh, whole.shape)

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)


def serve(model, caches, tokens, prefill, decode, steps, fed=None,
          sync=None):
    """A prefill of `tokens` (B,S) and `steps` decode steps through the
    serving steps `prefill` and `decode`, each fed `fed[i]` (B,) or else
    the previous step's greedy tokens: (the greedy tokens of every step,
    the caches, prefill ms, decode ms of each step), the times on the
    host clock, each between two `sync()` calls."""
    sync = sync or (lambda: None)
    sync()
    t0 = time.perf_counter()
    tok, caches = prefill(model, {"tokens": tokens}, caches)
    sync()
    pre_ms = (time.perf_counter() - t0) * 1e3
    toks, dec_ms = [tok], []
    for i in range(steps):
        t = tok if fed is None else fed[i]
        sync()
        t0 = time.perf_counter()
        tok, caches = decode(model, caches, t[:, None])
        sync()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    return toks, caches, pre_ms, dec_ms
