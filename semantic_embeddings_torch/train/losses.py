"""Embedding and classification losses (counterpart of the JAX package's
``train/losses.py``): the embedding losses, Keras's cross-entropy, and the
baseline learners' losses (DeViSE's ranking loss, label smoothing, the
label-embedding network's loss, the center loss).  The cosine loss also has
a fused kernel pair in :mod:`semantic_embeddings_torch.ops.cosine_loss`."""

from __future__ import annotations

import torch

_KERAS_EPS = 1e-7


def squared_distance(y_true, y_pred):
    """Per-sample squared Euclidean distance."""
    return torch.sum(torch.square(y_pred - y_true), dim=-1)


def inv_correlation(y_true, y_pred):
    """1 - <y_true, y_pred> — THE cosine loss, applied after L2
    normalization of the prediction."""
    return 1.0 - torch.sum(y_true * y_pred, dim=-1)


def categorical_crossentropy(y_true, probs):
    """Keras-style CE over probabilities (clipped like the Keras backend)."""
    probs = torch.clamp(probs, _KERAS_EPS, 1.0 - _KERAS_EPS)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    return -torch.sum(y_true * torch.log(probs), dim=-1)


def softmax_crossentropy_logits(y_true, logits):
    """Numerically stable CE from logits."""
    return -torch.sum(y_true * torch.log_softmax(logits, dim=-1), dim=-1)


def devise_ranking_loss(embedding, margin=0.1):
    """Max-margin ranking loss against all class embeddings (DeViSE).

    Returns a per-sample loss ``(target embedding rows, predicted
    embeddings) -> (B,)`` over the (n_classes, d) ``embedding`` table; the
    table moves to the prediction's device at the first call."""
    table = torch.as_tensor(embedding, dtype=torch.float32)
    cache = {}

    def loss(y_true, y_pred):
        emb = cache.get(y_pred.device)
        if emb is None:
            emb = cache[y_pred.device] = table.to(y_pred.device)
        true_sim = torch.sum(y_true * y_pred, dim=-1)
        other_sim = y_pred @ emb.T
        hinge = torch.relu(margin - true_sim[:, None] + other_sim)
        return torch.sum(hinge, dim=-1) - margin

    return loss


def label_smoothing(onehot, smoothing):
    """Spreads ``smoothing`` mass uniformly over the wrong classes."""
    if smoothing <= 0 or smoothing >= 1:
        return onehot
    n = onehot.shape[-1]
    return onehot * (1.0 - smoothing) + (1.0 - onehot) * (smoothing / (n - 1))


def labelembed_loss(out1, out2, tar, targets, tau=2.0, alpha=0.9, beta=0.5,
                    valid=None, batch_sum=None):
    """The label-embedding network's composite loss (Sun et al.), per sample.

    ``out1``/``out2``: the two classifier heads' logits; ``tar``: the learned
    label-embedding logits of the true class; ``targets``: integer labels.
    ``valid`` (optional, per-row 0/1): the L_emb_o2 term scales each row by
    ``rows / #correct-in-batch``; on a padded eval batch that scale counts
    the real rows only.  ``batch_sum`` (default: the identity) adds those
    counts over the rest of the batch where other processes hold it (the
    sum over a process group), so that a rank's rows take the global
    batch's scale.
    """
    num_classes = out1.shape[-1]
    onehot = torch.nn.functional.one_hot(targets, num_classes).to(out1.dtype)

    out2_prob = torch.softmax(out2, dim=-1)
    tau2_prob = torch.softmax(out2 / tau, dim=-1).detach()
    soft_tar = torch.softmax(tar, dim=-1).detach()

    l_o1_y = softmax_crossentropy_logits(onehot, out1)

    mask = (torch.argmax(out2, dim=-1) == targets).to(out1.dtype).detach()
    if valid is None:
        n_rows = torch.tensor(float(mask.shape[0]), dtype=out1.dtype, device=out1.device)
    else:
        v = valid.to(out1.dtype)
        mask = mask * v
        n_rows = torch.sum(v)
    n_correct = torch.sum(mask)
    if batch_sum is not None:
        n_rows, n_correct = batch_sum(torch.stack([n_rows, n_correct])).unbind(0)

    def xent(logit, prob):
        return torch.sum(prob * torch.log_softmax(logit, dim=-1), dim=-1)

    l_o1_emb = -xent(out1, soft_tar)
    l_o2_y = softmax_crossentropy_logits(onehot, out2)
    l_emb_o2 = -xent(tar, tau2_prob) * mask * (n_rows / (n_correct + 1e-8))
    l_re = torch.relu(torch.sum(out2_prob * onehot, dim=-1) - alpha)

    return beta * l_o1_y + (1 - beta) * l_o1_emb + l_o2_y + l_emb_o2 + l_re


def center_loss(embeddings, centroids, targets):
    """Half squared distance to the class centroid (Wen et al.)."""
    return torch.sum(torch.square(embeddings - centroids[targets]), dim=-1) / 2.0
