"""Taps on the serving and training paths, for holding a forward or a
train step on a mesh against the one-device one (`chip_smoke.py` phases
18 and 19 on the card, the ranks of `tests/test_torch_lm_mesh.py` and
`tests/test_torch_train_mesh.py` on the CPU).

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

`TrainTaps` does the same for training, forward and backward: it
records each layer call's input and the gradient reaching its output,
or feeds both from another run, so that each layer's weights' gradients
compare layer by layer.  `mesh_aux` gives a one-device run the MoE aux
loss of the expert-parallel layer on a mesh, the mean of the Switch
losses of the token blocks the mesh's ranks route.
"""
from __future__ import annotations

import time


def _shard_as(whole, like, mesh):
    """A whole tensor as `like` is: on its device and, for a DTensor
    `like`, this rank's shard of it placed as `like` is."""
    from repro_torch.sharding.axes import from_local, is_dtensor, local_part
    whole = whole.to(like.device)
    if not is_dtensor(like):
        return whole
    pl = like.placements
    return from_local(local_part(whole, pl, mesh).contiguous(), pl, mesh,
                      whole.shape)


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
                h = _shard_as(self.feed[i], h, self.mesh)
            out = block(blk, h, cfg, **kw)
            if self.on_layer is not None:
                self.layers.append(self.on_layer(i, h, out[0]))
            return out

        A._flash_op, A._decode_op, A.merge_partials = \
            flash_op, decode_op, merge_op
        S.ssd_scan, lm.forward, lm.apply_block = ssd_op, forward, apply_block
        return self

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)


def serve(model, caches, tokens, prefill, decode, steps, fed=None,
          sync=None, context=None):
    """A prefill of `tokens` (B,S) with `context` ({"img_embeds"} or
    {"frames"}, for a model with cross layers) and `steps` decode steps
    through the serving steps `prefill` and `decode`, each fed `fed[i]`
    (B,) or else the previous step's greedy tokens: (the greedy tokens
    of every step, the caches, prefill ms, decode ms of each step), the
    times on the host clock, each between two `sync()` calls."""
    sync = sync or (lambda: None)
    sync()
    t0 = time.perf_counter()
    tok, caches = prefill(model, dict(context or {}, tokens=tokens), caches)
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


class TrainTaps:
    """Taps on every layer of a forward (the encoder's too) and, in
    training, its backward.  A layer call is keyed (pass, "dec" or
    "enc", layer index), the pass counting `models.lm.forward` calls (one
    a microbatch, or a serving step).  Without `feed`, at a
    key's first call (remat calls a layer again in the backward pass) it
    records the layer's input in `inputs[key]` and the gradient reaching
    its output in `grads[key]`, whole tensors.  With `feed`, another
    run's (`inputs`, `grads`), each layer call runs on the fed input —
    its value replaced, its gradient still flowing to the layer below —
    and the gradient reaching its output is replaced by the fed one; on
    a mesh each is this rank's shard of the whole tensor, placed as the
    layer's input or output is (`mesh`).  Each layer's forward and
    backward then see the other run's operands, and its weights'
    gradients compare without the chaos that random weights give a whole
    model.  It also keeps the gradients each step hands AdamW
    (`updates`, one {name: gradient} a step) and the collectives made
    (`collectives`, a list of records a call): at use (`gather`: ZeRO-3's
    all-gathers; `reduce`: their gradients' reductions), in the
    vocabulary-parallel cross entropy (`xent`) and in `global_norm`
    (`norm`)."""

    #: where a collective is recorded: (module, function) by name
    WATCHED = {"gather": ("lm", "_at_use"), "reduce": ("lm", "_reduce_at_use"),
               "xent": ("common", "_cross_entropy_sharded"),
               "norm": ("adamw", "global_norm")}

    def __init__(self, mesh=None, feed=None):
        self.mesh, self.feed = mesh, feed
        self.inputs, self.grads = {}, {}
        self.updates, self.collectives = [], {k: [] for k in self.WATCHED}
        self.passes = 0
        self._hooked = set()

    def __enter__(self):
        from repro_torch.launch.comm_stats import CollectiveRecorder
        from repro_torch.models import common, lm
        from repro_torch.optim import adamw
        mods = {"lm": lm, "common": common, "adamw": adamw}
        self._saved = [(lm, n, getattr(lm, n))
                       for n in ("forward", "apply_block", "_encoder_block")]
        fwd, block, enc = (f for _, _, f in self._saved)
        for what, (m, n) in self.WATCHED.items():
            f = getattr(mods[m], n)
            self._saved.append((mods[m], n, f))

            def watched(*a, _f=f, _rec=self.collectives[what], **kw):
                with CollectiveRecorder() as rec:
                    out = _f(*a, **kw)
                _rec.append(rec.records)
                return out
            setattr(mods[m], n, watched)
        update = adamw.adamw_update
        self._saved.append((adamw, "adamw_update", update))

        def adamw_update(params, grads, *a, **kw):
            self.updates.append({n: g.detach().clone()
                                 for n, g in grads.items()})
            return update(params, grads, *a, **kw)
        adamw.adamw_update = adamw_update

        def forward(*a, **kw):
            self.passes += 1
            return fwd(*a, **kw)

        def apply_block(blk, h, cfg, **kw):
            key = (self.passes, "dec", blk.index)
            out = block(blk, self._input(key, h), cfg, **kw)
            self._output(key, out[0])
            return out

        def encoder_block(blk, h, cfg, *a, **kw):
            key = (self.passes, "enc", blk.index)
            out = enc(blk, self._input(key, h), cfg, *a, **kw)
            self._output(key, out)
            return out

        lm.forward, lm.apply_block, lm._encoder_block = \
            forward, apply_block, encoder_block
        return self

    def _input(self, key, h):
        if self.feed is None:
            self.inputs.setdefault(key, h.detach().clone())
            return h
        return h + (_shard_as(self.feed[0][key], h, self.mesh) - h).detach()

    def _output(self, key, y):
        if key in self._hooked or not y.requires_grad:
            return
        self._hooked.add(key)
        if self.feed is None:
            def hook(g):
                self.grads[key] = g.detach().clone()
        else:
            fed = _shard_as(self.feed[1][key], y, self.mesh)

            def hook(g):
                return fed
        y.register_hook(hook)

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)


class mesh_aux:
    """`with mesh_aux(data, model):` a one-device run's MoE layers return
    the aux loss that `moe_apply` returns on a ("data", "model") mesh of
    that shape: the mean of the Switch losses of the token blocks the
    ranks route — the batch rows split `data` ways where they divide,
    and, where the sequence divides over the expert axis (the all-to-all
    form), the sequence split `model` ways — in place of the whole
    batch's.  The layer's output is the dense form's."""

    def __init__(self, data: int, model: int):
        self.data, self.model = data, model

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self._saved = moe.moe_apply

        def moe_apply(p, x, cfg, mesh=None):
            y, _ = self._saved(p, x, cfg, mesh)
            B, S, D = x.shape
            nb = self.data if B % self.data == 0 else 1
            ns = self.model if S % self.model == 0 else 1
            auxes = [moe._route(blk.reshape(-1, D), p["router"], cfg)[2]
                     for rows in x.chunk(nb, dim=0)
                     for blk in rows.chunk(ns, dim=1)]
            return y, torch.stack(auxes).mean()

        moe.moe_apply = moe_apply
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_apply = self._saved
