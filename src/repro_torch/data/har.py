"""Synthetic surrogate of the UCI-HAR dataset (paper [1]) with subject drift.

The port's own copy of ``repro/data/har.py`` (numpy only): the same seed
gives byte-identical arrays in both packages.

The real dataset is not redistributable with this repository.  This generator mirrors its published structure:

  * 30 human subjects, 6 classes (Walking, WalkUp, WalkDown, Sitting,
    Standing, Laying), 561-dim feature vectors in [-1, 1];
  * samples cluster per (subject, class) — Fig. 1 of the paper shows strong
    per-subject clustering for Walking/WalkUp/WalkDown/Laying, weaker for
    Sitting/Standing;
  * ~10k samples total, ~70/30 train/test split per subject;
  * high sample redundancy within a (subject, class) cluster (the property
    that makes data pruning effective — paper §3.2).

Drift protocol (paper §3): subjects {9, 14, 16, 19, 25} are held out of
train/test0 and form test1.  The held-out subjects get the largest subject
offsets so the shift is material (NoODL drops ~10 accuracy points).
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_SUBJECTS = 30
N_CLASSES = 6
N_FEATURES = 561
DRIFT_SUBJECTS = (9, 14, 16, 19, 25)
CLASS_NAMES = ("Walking", "WalkUp", "WalkDown", "Sitting", "Standing", "Laying")


@dataclasses.dataclass
class HARSplits:
    train_x: np.ndarray
    train_y: np.ndarray
    test0_x: np.ndarray
    test0_y: np.ndarray
    test1_x: np.ndarray
    test1_y: np.ndarray


def _subject_scale(subject_rng: np.random.Generator, drifted: bool) -> float:
    # Held-out subjects sit farther from the population mean (paper Fig. 1:
    # the removed subjects form distinguishable clusters).  1.45 calibrated so
    # NoODL(N=128) lands on the paper's 82.9 % post-drift accuracy (Table 3).
    return 1.45 if drifted else 1.0


def generate(
    seed: int = 0,
    samples_per_subject_class: int = 56,
    subject_sigma: float = 0.17,
    class_sep: float = 0.13,
    noise_sigma: float = 0.35,
    hard_frac: float = 0.15,
    hard_scale: float = 1.8,
) -> HARSplits:
    """Build the drifted HAR surrogate.

    x[s, c, i] = tanh( mu_class[c] + scale_s * delta_subject[s, c] + sigma_i * eps_i )

    Per-sample noise ``sigma_i`` is bimodal: a ``1 - hard_frac`` majority of
    near-duplicate "cluster core" samples (continuous sensor streams are
    highly redundant — paper §3.2) plus a ``hard_frac`` minority of boundary
    samples with ``hard_scale``x the noise.  This is what makes confidence
    well-calibrated and P1P2 pruning effective: core samples are
    high-confidence/high-accuracy, boundary samples low-confidence.
    """
    rng = np.random.default_rng(seed)
    # Class prototypes: drawn sparse-ish so classes are linearly separable.
    mu = rng.normal(0.0, class_sep, size=(N_CLASSES, N_FEATURES))
    # Static-posture classes (Sitting/Standing) are closer together (Fig. 1).
    mu[4] = mu[3] + rng.normal(0.0, 0.35 * class_sep, size=N_FEATURES)

    xs, ys, subs = [], [], []
    for s in range(N_SUBJECTS):
        srng = np.random.default_rng(seed * 1009 + 7 * s + 1)
        drifted = s in DRIFT_SUBJECTS
        scale = _subject_scale(srng, drifted)
        # Per-(subject, class) offset — the clusters of Fig. 1.
        delta = srng.normal(0.0, subject_sigma, size=(N_CLASSES, N_FEATURES))
        for c in range(N_CLASSES):
            center = mu[c] + scale * delta[c]
            k = samples_per_subject_class
            eps = srng.normal(0.0, noise_sigma, size=(k, N_FEATURES))
            hard = (srng.uniform(size=k) < hard_frac).astype(np.float64)
            sigma = (0.35 + hard * (hard_scale - 0.35))[:, None]
            x = np.tanh(center[None, :] + sigma * eps)
            xs.append(x)
            ys.append(np.full(k, c, dtype=np.int32))
            subs.append(np.full(k, s, dtype=np.int32))

    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    sub = np.concatenate(subs)

    # Shuffle globally, then split.
    perm = rng.permutation(len(x))
    x, y, sub = x[perm], y[perm], sub[perm]

    drift_mask = np.isin(sub, DRIFT_SUBJECTS)
    keep_x, keep_y = x[~drift_mask], y[~drift_mask]
    test1_x, test1_y = x[drift_mask], y[drift_mask]

    # 70/30 train/test0 split of the kept subjects (paper reuses the dataset's
    # original split; exact fractions are immaterial to the protocol).
    n_train = int(0.7 * len(keep_x))
    return HARSplits(
        train_x=keep_x[:n_train],
        train_y=keep_y[:n_train],
        test0_x=keep_x[n_train:],
        test0_y=keep_y[n_train:],
        test1_x=test1_x,
        test1_y=test1_y,
    )


def odl_split(splits: HARSplits, frac: float = 0.6, seed: int = 0, bout_len: int = 70):
    """Paper §3 steps 3-4: ~60% of test1 for ODL retraining, rest for test.

    The retraining portion is arranged as a *temporally coherent stream*:
    contiguous bouts of ~``bout_len`` same-class samples (a person walks for a
    while, then sits for a while, ...), which is how the smartphone dataset is
    actually recorded.  Bout structure is what makes consecutive-success
    streaks (the auto-theta X=10 rule) attainable on real sensor streams.
    The held-out test portion stays i.i.d.-shuffled.
    """
    rng = np.random.default_rng(seed + 12345)
    n = len(splits.test1_x)
    perm = rng.permutation(n)
    k = int(frac * n)
    tr, te = perm[:k], perm[k:]
    tx, ty = splits.test1_x[tr], splits.test1_y[tr]

    # Group the training portion by class, then emit random-order bouts.
    by_class = [np.where(ty == c)[0] for c in range(N_CLASSES)]
    for idxs in by_class:
        rng.shuffle(idxs)
    cursors = [0] * N_CLASSES
    order = []
    while any(cursors[c] < len(by_class[c]) for c in range(N_CLASSES)):
        avail = [c for c in range(N_CLASSES) if cursors[c] < len(by_class[c])]
        c = int(rng.choice(avail))
        L = int(rng.integers(bout_len // 2, bout_len * 3 // 2 + 1))
        take = by_class[c][cursors[c] : cursors[c] + L]
        cursors[c] += len(take)
        order.extend(take.tolist())
    order = np.asarray(order, dtype=np.int64)

    return tx[order], ty[order], splits.test1_x[te], splits.test1_y[te]


def drift_tick_stream(
    splits: HARSplits,
    n_streams: int = 1,
    frac: float = 0.6,
    seed: int = 0,
    bout_len: int = 70,
    calm: int = 0,
    severities=None,
):
    """Tick-iterator view of the drifted ODL stream for the streaming
    runtime (``repro_torch.engine.stream.run``): one ``(S, n_in)`` float32 tick at
    a time, never materializing the full ``(T, S, n_in)`` array.

    The stream is an optional ``calm``-tick prefix of known-subject (test0)
    data followed by the §3 retraining stream of the held-out subjects,
    with a per-stream drift ``severities`` multiplier applied at shift time
    (``x -> clip(x * sev + 0.4 * sev, -3, 3)`` — S users hitting the same
    drift at different strengths).  Defaults to severity 1.0 (no extra
    scaling) for every stream.

    Returns ``(ticks, labels)``: ``ticks`` is a generator of (S, n_in)
    ticks and ``labels`` the matching (T, S) int32 ground-truth array for
    the teacher side (labels are 1 byte/tick/stream — the paper's protocol
    has ground truth play the teacher; it is the features that must not
    materialize).
    """
    ox, oy, _, _ = odl_split(splits, frac, seed, bout_len)
    if severities is None:
        severities = np.ones(n_streams, np.float32)
    severities = np.asarray(severities, np.float32)
    if severities.shape != (n_streams,):
        raise ValueError(f"severities must be ({n_streams},), got {severities.shape}")
    calm_x, calm_y = splits.test0_x[:calm], splits.test0_y[:calm]
    if len(calm_x) < calm:
        raise ValueError(f"calm prefix {calm} exceeds test0 size {len(splits.test0_x)}")
    labels = np.concatenate([calm_y, oy]).astype(np.int32)
    labels = np.broadcast_to(labels[:, None], (len(labels), n_streams))

    def ticks():
        for row in calm_x:
            yield np.broadcast_to(row, (n_streams, N_FEATURES)).astype(np.float32)
        scale = severities[:, None]
        for row in ox:
            yield np.clip(row[None, :] * scale + 0.4 * scale, -3, 3).astype(np.float32)

    return ticks(), labels
