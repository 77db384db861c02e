"""The train and eval steps of the three STCD stages (counterpart of
stcd_tpu/train/steps.py): ``make_seg_steps`` (stage 1, supervised
segmentation), ``make_cd_steps`` (stage 2, pseudo-change pretraining) and
``make_semi_cd_steps`` (stage 3, the fine-tune on synthesized and real pairs).

A batch holds NHWC images, (N, H, W, 3) uint8 or float in [0, 1], and labels
(N, H, W, 1), all on the state's device. Augmentation and ImageNet
normalisation run inside the step on that device; on a card the augmentation
is the CUDA kernel of ``ops/augment.py``, launched once a step over all the
step's images, whose NHWC output is a channels_last NCHW tensor for the model
without a copy. The confusion counts are taken on the device and returned
with the losses as tensors: a step forces no host sync.

Every ``make_*_steps`` takes ``model`` for the JAX function's signature and does not
use it: the steps run the state's module. All three share ``augment``,
``remat`` and ``accum_steps``:

``accum_steps > 1`` runs that many micro-batches in order: gradients
averaged, BatchNorm running statistics updated per micro-batch, the losses
averaged and the counts summed. ``remat=True`` recomputes the model's forward
in the backward (``torch.utils.checkpoint``); the recomputation leaves the
BatchNorm buffers as the first forward set them.

Every train step is ``train_step(state, batch, generator=None,
aug_params=None, augment_impl=None)``: it updates ``state`` in place and
returns a dict of tensors. ``generator`` gives the augmentation's draws and
the model's dropout and DropPath masks; ``aug_params`` replaces the sampling
of the augmentation, so that draws made elsewhere can drive the step.

Under a process group of W > 1 ranks (``parallel.distributed``) the steps
compute the one-process step on the global batch, as the JAX steps do on a
batch sharded over the mesh. Rank r holds the global rows ``r::W`` (the
loader's split). Every rank draws the augmentation's and the model's
per-row randomness for the global batch from the same seeded generator and
keeps its rows (``aug_params`` are the global batch's draws too), and the
augmentation then runs on the rank's own rows. BatchNorm's moments and the
ratio losses are global (layers/norm.py, losses/functional.py), the
gradients are averaged over the ranks by one flat all-reduce after the
backward (``distributed.average_gradients``), and the step returns the
global loss terms and counts on every rank. Under ``accum_steps`` the global
micro-batch i is the union of every rank's contiguous local micro-batch i,
so the local batch must split into ``accum_steps`` parts.

``space > 1`` gives the spatial steps (``parallel/spatial.py``, the
``make_spatial_*_steps`` there): the ranks form a data x space grid
(``parallel.mesh.create_mesh``), and "rank" above reads "data shard" (the
loader's split, the draws' rows). A data shard's augmentation runs on its
full rows; then each rank cuts its strip of the rows of the images and
labels, and the forward and the loss run inside ``spatial_context``. The
losses and counts summed over every rank are those of the global batch. The
eval step returns the counts of this rank's strip (``loops.evaluate`` sums
them over the ranks) and the whole images' probabilities, gathered over the
space group. ``remat`` under a space axis raises (ROADMAP.md Queue 3 known
issue 12).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from stcd_tpu_torch.data.augment import (concat_params, eval_preprocess, params_to,
                                         sample_augment_params, sample_pair_params,
                                         select_params, train_augment, train_augment_pair)
from stcd_tpu_torch.layers.stochastic import RowMap, set_generator
from stcd_tpu_torch.losses.functional import bce_dice, contrastive_loss
from stcd_tpu_torch.metrics.confusion import confusion_matrix, global_counts
from stcd_tpu_torch.parallel import distributed, spatial


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _label_nchw(label: torch.Tensor) -> torch.Tensor:
    if label.dim() == 3:
        label = label[..., None]
    return _nchw(label)


def _forward(state, *inputs):
    with state.autocast():
        return state.model(*inputs)


def _micro_slices(n: int, accum_steps: int):
    """The local rows of each micro-batch. Across W ranks global micro-batch
    i is every rank's local slice i, which needs W to divide its size."""
    if n % accum_steps != 0:
        world = distributed.data_size()
        where = (f" (a global batch of {n * world} over {world} ranks: {world} must divide "
                 f"the micro-batch of {n * world / accum_steps:g})") if world > 1 else ""
        raise ValueError(f"batch {n} not divisible by accum_steps {accum_steps}{where}")
    m = n // accum_steps
    return [slice(i * m, (i + 1) * m) for i in range(accum_steps)]


def _own_rows(params):
    """The rows of the global batch's draws (a dict, or nested tuples of
    dicts) that this rank holds; the draws themselves in one process."""
    if not distributed.data_parallel():
        return params
    if isinstance(params, (tuple, list)):
        return tuple(_own_rows(p) for p in params)
    return select_params(params, distributed.global_batch_sharding())


def _row_map(n_local: int, device) -> Optional[RowMap]:
    """Where this rank's ``n_local`` rows of a (micro-)batch sit in the
    global one, for the model's dropout and DropPath draws."""
    if not distributed.data_parallel():
        return None
    world, rank = distributed.data_size(), distributed.data_rank()
    return RowMap(n_local, n_local * world,
                  torch.arange(rank, n_local * world, world, device=device), rank, world)


def _global_outputs(out: dict) -> dict:
    """The step's outputs over the global batch: every loss term averaged over
    the ranks (a ratio loss is the same on each, a mean of per-sample terms
    is the mean of the ranks', whose rows or strips are equal in number), the
    counts summed."""
    if not distributed.data_parallel():
        return out
    terms = [k for k in out if k != "cm"]
    means = distributed.all_reduce_(torch.stack([out[k].double() for k in terms]))
    means /= distributed.data_group_size()
    return {**{k: means[i].to(out[k].dtype) for i, k in enumerate(terms)},
            "cm": global_counts(out["cm"])}


def _accum_update(state, micro: Callable, accum_steps: int, n_micro: int, remat: bool,
                  generator: Optional[torch.Generator], space: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """The micro-batch loop that the three train steps share, and one
    optimizer update. ``micro(i) -> (model inputs, loss_of)`` gives micro-batch
    i's inputs and a function from the model's output to
    ``(loss, counts, extra loss terms)``; ``n_micro`` is the rows of one. Returns
    the mean loss, the summed counts and the mean extras, of this rank's rows.
    The model's dropouts and DropPaths draw from ``generator``
    (``layers/stochastic.py``), as the JAX steps draw them from the step's
    key; the recomputed forward of ``remat`` draws the same masks. Across
    ranks the gradients are averaged before the update. With ``space > 1``
    the forward and the loss run inside ``spatial_context(space)``."""
    model = set_generator(state.model.train(), generator,
                          _row_map(n_micro, state.device))
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum, cm, extras_sum = 0.0, 0, ()
    for i in range(accum_steps):
        inputs, loss_of = micro(i)
        if remat:
            drawn_from = generator.get_state() if generator is not None else None

            def forward(*inputs):
                if drawn_from is not None:
                    generator.set_state(drawn_from)
                return _forward(state, *inputs)

            out = checkpoint(forward, *inputs, use_reentrant=False)
            buffers = [buf.clone() for buf in model.buffers()]
            loss, micro_cm, extras = loss_of(out)
        else:
            with _space_context(space):
                loss, micro_cm, extras = loss_of(_forward(state, *inputs))
        (loss / accum_steps).backward()
        if remat:  # the recomputed forward updated the running stats again
            with torch.no_grad():
                for buf, saved in zip(model.buffers(), buffers):
                    buf.copy_(saved)
        loss_sum = loss_sum + loss.detach()
        cm = cm + micro_cm
        extras = tuple(e.detach() for e in extras)
        extras_sum = tuple(a + b for a, b in zip(extras_sum, extras)) if extras_sum else extras
    distributed.average_gradients(model.parameters())
    state.apply_gradients()
    return loss_sum / accum_steps, cm, tuple(e / accum_steps for e in extras_sum)


def _space_context(space: int):
    return spatial.spatial_context(space) if space > 1 else contextlib.nullcontext()


def _check_space(space: int, remat: bool) -> None:
    if space > 1 and remat:
        raise ValueError(f"--remat under a space axis of {space}: the recomputed forward "
                         "would run outside the halo exchange (ROADMAP.md Queue 3 known "
                         "issue 12)")


def _strips(space: int, *tensors):
    """This rank's strip of each NCHW tensor (the tensors with a space axis of
    1)."""
    return tensors if space == 1 else tuple(spatial.strip(t) for t in tensors)


def _eval_outputs(space: int, probs: torch.Tensor, label: torch.Tensor) -> dict:
    """The eval step's counts of ``probs`` (NCHW, this rank's strip under a
    space axis) and the probabilities as (N, H, W, 1), of the whole images."""
    label = _label_nchw(label)
    if space > 1:
        cm = confusion_matrix(probs > 0.5, spatial.strip(label))
        probs = spatial.gather_strips(probs)
    else:
        cm = confusion_matrix(probs > 0.5, label)
    return {"cm": cm, "probs": probs.permute(0, 2, 3, 1)}


def _eval_forward(state, space: int, *inputs):
    with _space_context(space):
        return _forward(state, *_strips(space, *inputs))


def _binary_loss(logits: torch.Tensor, label: torch.Tensor):
    """BCE + Dice on sigmoid(logits), and the counts at threshold 0.5."""
    probs = torch.sigmoid(logits.float())
    return bce_dice(probs, label), confusion_matrix(probs.detach() > 0.5, label), ()


def make_seg_steps(model=None, augment: bool = True, remat: bool = False,
                   accum_steps: int = 1, space: int = 1):
    """Supervised segmentation (stage 1). Returns ``(train_step, eval_step)``.

    ``train_step(state, batch{image, label}, ...) -> {"loss", "cm"}``: every
    image draws its own augmentation coins and factors (``aug_params``: one
    dict of draws), forward in train mode, loss = BCE + Dice on
    sigmoid(mask logit), one optimizer update.

    ``eval_step(state, batch) -> {"cm", "probs"}``: eval mode, no grad,
    probabilities as (N, H, W, 1)."""
    _check_space(space, remat)

    def train_step(state, batch, generator: Optional[torch.Generator] = None,
                   aug_params=None, augment_impl: Optional[str] = None):
        n = batch["image"].shape[0]
        slices = _micro_slices(n, accum_steps)
        if augment:
            if aug_params is None:
                aug_params = sample_augment_params(generator, n * distributed.data_size(),
                                                   0.5)
            image = train_augment(generator, batch["image"], aug_params=_own_rows(aug_params),
                                  impl=augment_impl)
        else:
            image = eval_preprocess(batch["image"])
        image, label = _strips(space, _nchw(image), _label_nchw(batch["label"]).float())

        def micro(i):
            ml = label[slices[i]]
            return (image[slices[i]],), lambda pred: _binary_loss(pred, ml)

        loss, cm, _ = _accum_update(state, micro, accum_steps, n // accum_steps, remat,
                                    generator, space)
        return _global_outputs({"loss": loss, "cm": cm})

    @torch.no_grad()
    def eval_step(state, batch):
        state.model.eval()
        pred = _eval_forward(state, space, _nchw(eval_preprocess(batch["image"])))
        return _eval_outputs(space, torch.sigmoid(pred.float()), batch["label"])

    return train_step, eval_step


def make_cd_steps(model=None, augment: bool = True, remat: bool = False,
                  accum_steps: int = 1, space: int = 1):
    """Pseudo-change CD pretraining (stage 2). Returns
    ``(train_step, eval_step)``.

    ``train_step(state, batch{A, B, label}, ...) -> {"loss", "cm"}``: augment
    the 2N images in one call (one jitter coin per pair; ``aug_params``: the
    pair of draw dicts for A and B), forward in train mode, loss = BCE + Dice
    on sigmoid(change logit), one optimizer update.

    ``eval_step(state, batch) -> {"cm", "probs"}``: eval mode, no grad,
    probabilities as (N, H, W, 1)."""
    _check_space(space, remat)

    def train_step(state, batch, generator: Optional[torch.Generator] = None,
                   aug_params=None, augment_impl: Optional[str] = None):
        n = batch["A"].shape[0]
        slices = _micro_slices(n, accum_steps)
        if augment:
            if aug_params is None:
                aug_params = sample_pair_params(generator, n * distributed.data_size(), 0.5)
            a, b = train_augment_pair(generator, batch["A"], batch["B"], jitter_p=0.5,
                                      aug_params=_own_rows(aug_params), impl=augment_impl)
        else:
            a, b = eval_preprocess(batch["A"]), eval_preprocess(batch["B"])
        a, b, label = _strips(space, _nchw(a), _nchw(b), _label_nchw(batch["label"]).float())

        def micro(i):
            ml = label[slices[i]]
            return (a[slices[i]], b[slices[i]]), lambda out: _binary_loss(out[2], ml)

        loss, cm, _ = _accum_update(state, micro, accum_steps, n // accum_steps, remat,
                                    generator, space)
        return _global_outputs({"loss": loss, "cm": cm})

    @torch.no_grad()
    def eval_step(state, batch):
        state.model.eval()
        a, b = _nchw(eval_preprocess(batch["A"])), _nchw(eval_preprocess(batch["B"]))
        diff = _eval_forward(state, space, a, b)[2]
        return _eval_outputs(space, torch.sigmoid(diff.float()), batch["label"])

    return train_step, eval_step


def make_semi_cd_steps(model=None, augment: bool = True, remat: bool = False,
                       accum_steps: int = 1, space: int = 1):
    """The STCD fine-tune (stage 3). Returns ``(train_step, eval_step)``.

    A batch carries N synthesized pseudo-change pairs (``A``, ``B`` with the
    labels ``s_label_A`` and ``c_label``) and N real pairs (``CA``, ``CB``
    with the label ``CL``). ``train_step -> {"loss", "seg_loss", "cd_loss",
    "ct_loss", "cm"}``: the synthesized pairs are augmented with one jitter
    coin per pair at p = 0.5 and the real pairs at p = 0.8, all 4N images in
    one augmentation call (``aug_params``: ``((draws A, draws B), (draws CA,
    draws CB))``); synthesized and real pairs are concatenated along the batch,
    synthesized first, for one SegCD forward; loss = BCE + Dice of the mask of
    A on the first N rows + BCE + Dice of the change map on all 2N + the
    contrastive loss between the two halves. The counts cover all 2N pairs.
    Under accumulation each micro-batch concatenates its own slices of the two
    halves. ``eval_step`` is stage 2's."""
    _check_space(space, remat)

    def train_step(state, batch, generator: Optional[torch.Generator] = None,
                   aug_params=None, augment_impl: Optional[str] = None):
        from stcd_tpu_torch.ops.augment import apply_augment_batch

        names = ("A", "B", "CA", "CB")
        n = batch["A"].shape[0]
        if augment:
            if aug_params is None:
                world = distributed.data_size()
                aug_params = (sample_pair_params(generator, n * world, 0.5),
                              sample_pair_params(generator, batch["CA"].shape[0] * world, 0.8))
            own = _own_rows(aug_params)
            draws = concat_params(*own[0], *own[1])
            images = torch.cat([batch[k] for k in names], dim=0)
            out = apply_augment_batch(images, params_to(draws, images.device),
                                      impl=augment_impl)
            a, b, ca, cb = out.split([batch[k].shape[0] for k in names], dim=0)
        else:
            a, b, ca, cb = (eval_preprocess(batch[k]) for k in names)
        a, b, ca, cb, s_label, cd_label, real_label = _strips(
            space, *(_nchw(t) for t in (a, b, ca, cb)),
            *(_label_nchw(batch[k]).float() for k in ("s_label_A", "c_label", "CL")))
        if ca.shape[0] != n:
            raise ValueError(f"{n} synthesized pairs but {ca.shape[0]} real pairs")
        slices = _micro_slices(n, accum_steps)

        def micro(i):
            sl = slices[i]
            data_a = torch.cat([a[sl], ca[sl]], dim=0)
            data_b = torch.cat([b[sl], cb[sl]], dim=0)
            ms, mcd, mcl = s_label[sl], cd_label[sl], real_label[sl]
            labels = torch.cat([mcd, mcl], dim=0)

            def loss_of(out):
                seg_probs = torch.sigmoid(out[0].float())
                cd_probs = torch.sigmoid(out[2].float())
                seg_loss = bce_dice(seg_probs[:ms.shape[0]], ms)
                cd_loss = bce_dice(cd_probs, labels)
                ct_loss = contrastive_loss(cd_probs, mcd, mcl)
                cm = confusion_matrix(cd_probs.detach() > 0.5, labels)
                return seg_loss + cd_loss + ct_loss, cm, (seg_loss, cd_loss, ct_loss)

            return (data_a, data_b), loss_of

        loss, cm, (seg_loss, cd_loss, ct_loss) = _accum_update(
            state, micro, accum_steps, n // accum_steps, remat, generator, space)
        return _global_outputs({"loss": loss, "seg_loss": seg_loss, "cd_loss": cd_loss,
                                "ct_loss": ct_loss, "cm": cm})

    _, eval_step = make_cd_steps(model, augment=False, space=space)
    return train_step, eval_step
