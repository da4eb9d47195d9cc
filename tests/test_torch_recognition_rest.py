"""Recognition's TLD tracker, bag of words and DeepBoof classifiers, and
``utils/profiling``: the port against the JAX package on the same seeded
numpy inputs, on the CPU; and the three examples that use them.

Tolerances: TLD's fern pairs, posteriors and templates after
``initialize`` are equal (the same numpy generator; ``_patch`` is
bit-equal); found flags are equal on every frame, boxes within 1e-4 px
(the median-flow KLT sums float32 steps in another order: about 1e-5 px
seen).  k-means centres within 1e-5 relative of the data's scale (float32
one-hot sums in another order), assignments equal away from near-ties,
histograms and labels equal.  Network logits within 1e-4 relative of their
largest magnitude (float32 convolutions in another order; 1e-6 seen), the
loss gradient within 1e-4 relative of each parameter's largest entry.
"""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.recognition import deepboof as jdb
from boofcv_tpu.recognition import scene as jscene
from boofcv_tpu.recognition import tld as jtld
from boofcv_tpu_torch.recognition import deepboof as tdb
from boofcv_tpu_torch.recognition import scene as tscene
from boofcv_tpu_torch.recognition import tld as ttld
from boofcv_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_scene_tld as ref  # noqa: E402  (the reference's TLD scenes)

torch.set_num_threads(1)
CPU = "cpu"
BOX_TOL = 1e-4


# --- TLD -----------------------------------------------------------------

def _scene_jump(rng):
    f0 = ref._object_frame(rng, 40, 50)
    frames = [ref._object_frame(rng, cy, cx)
              for cy, cx in [(44, 56), (48, 62), (80, 110)]]
    return f0, frames, None


def _scene_flow(rng):
    f0 = ref._object_frame(rng, 40, 50)
    frames = [ref._object_frame(rng, cy, cx)
              for cy, cx in [(42, 53), (44, 56), (46, 59), (48, 62)]]

    def abstain(t):
        t.cfg.ncc_confirm = 1.01
    return f0, frames, abstain


def _scene_scale(rng):
    f0 = ref._object_frame_scaled(rng, 40, 50, 1.0)
    frames = [ref._object_frame_scaled(rng, cy, cx, 1.0)
              for cy, cx in [(43, 55), (46, 60)]]
    frames += [rng.normal(100, 3, (120, 160)).astype(np.float32)
               for _ in range(2)]
    frames += [ref._object_frame_scaled(rng, 78, 112, 1.7)
               for _ in range(3)]
    return f0, frames, None


SCENES = {"jump": (_scene_jump, 2), "median_flow": (_scene_flow, 5),
          "reacquire_scaled": (_scene_scale, 5)}


def _both_trackers(name):
    """(JAX tracker, port tracker, frames) initialized on one scene with
    one seed."""
    make, seed = SCENES[name]
    out = []
    for mod, kw in ((jtld, {}), (ttld, {"device": CPU})):
        f0, frames, setup = make(np.random.default_rng(seed))
        t = mod.make_tracker(**kw)
        t.initialize(f0, 40, 50, 24, 24)
        if setup is not None:
            setup(t)
        out.append(t)
    return out[0], out[1], frames


def _same_models(jt, tt):
    np.testing.assert_array_equal(tt.fern_pairs, jt.fern_pairs)
    np.testing.assert_array_equal(tt.posteriors_p, jt.posteriors_p)
    np.testing.assert_array_equal(tt.posteriors_n, jt.posteriors_n)
    for lst in ("pos_templates", "neg_templates"):
        a, b = getattr(jt, lst), getattr(tt, lst)
        assert len(a) == len(b), lst
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tld_matches_reference(name):
    jt, tt, frames = _both_trackers(name)
    _same_models(jt, tt)
    assert tt.init_var == jt.init_var and tt.box == jt.box
    for i, frame in enumerate(frames):
        jok, jbox = jt.process(frame)
        tok, tbox = tt.process(frame)
        assert tok == jok, (i, jbox, tbox)
        np.testing.assert_allclose(tbox, jbox, rtol=0, atol=BOX_TOL)
    assert len(tt.pos_templates) == len(jt.pos_templates)
    assert len(tt.neg_templates) == len(jt.neg_templates)


def test_tld_reference_bars_hold():
    """The reference tests' bars, on the port."""
    _, tt, frames = _both_trackers("reacquire_scaled")
    found = [tt.process(f) for f in frames]
    ok, box = next((r for r in found[4:] if r[0]), (False, None))
    assert ok and abs(box[0] - 78) < 8 and abs(box[1] - 112) < 8
    assert 1.3 * 24 < box[2] < 2.2 * 24


def test_linspace_and_patch_bit_equal():
    """``linspace_xla`` against ``jnp.linspace`` on TLD's own arguments
    (boxes of the detector's scales 1.2^k, centres on and off the grid,
    boxes past the border), and ``_patch`` against the reference's."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    jt = jtld.make_tracker()
    tt = ttld.make_tracker(device=CPU)
    dev_img = torch.from_numpy(img)
    boxes = []
    for _ in range(60):
        s = 1.2 ** rng.integers(-5, 6)
        h, w = 24 * s * rng.uniform(0.9, 1.1), 24 * s
        cy, cx = rng.uniform(-5, 125), rng.uniform(-5, 165)
        if rng.random() < 0.3:
            cy, cx = float(np.floor(cy)), float(np.floor(cx)) + 0.5
        boxes.append((float(cy), float(cx), float(h), float(w)))
        for a, b in ((cy - h / 2, cy + h / 2), (cx - w / 2, cx + w / 2)):
            want = np.asarray(jnp.linspace(a, b, 15))
            assert want.dtype == np.float64
            np.testing.assert_array_equal(ttld.linspace_xla(a, b, 15), want)
    for n in (2, 3, 9, 21):
        want = np.asarray(jnp.linspace(3.25, 97.125, n))
        np.testing.assert_array_equal(ttld.linspace_xla(3.25, 97.125, n),
                                      want)
    got = tt._patches(dev_img, boxes)
    for bx, g in zip(boxes, got):
        np.testing.assert_array_equal(g, jt._patch(img, *bx))
        np.testing.assert_array_equal(tt._patch(dev_img, *bx), g)


def test_tracker_from_numpy_continues_reference():
    jt, _, frames = _both_trackers("reacquire_scaled")
    for f in frames[:3]:
        jt.process(f)
    state = {k: getattr(jt, k) for k in ttld._STATE}
    state["cfg"] = vars(jt.cfg)
    tt = ttld.tracker_from_numpy(state, device=CPU)
    _same_models(jt, tt)
    for f in frames[3:]:
        jok, jbox = jt.process(f)
        tok, tbox = tt.process(f)
        assert tok == jok
        np.testing.assert_allclose(tbox, jbox, rtol=0, atol=BOX_TOL)


def test_tld_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttld.make_tracker()


# --- bag of words ----------------------------------------------------------

def _clusters():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal([0, 0], 0.3, (50, 2)),
                           rng.normal([5, 5], 0.3, (50, 2))])


def _jax_choice(key, n, k):
    """The reference kmeans's initial rows (``scene.py:25``)."""
    return np.asarray(jax.random.choice(key, n, (k,), replace=False))


@pytest.mark.parametrize("k,iters", [(2, 25), (5, 10), (7, 1)])
def test_kmeans_with_injected_indices(k, iters):
    pts = _clusters()
    key = jax.random.PRNGKey(k)
    want = np.asarray(jscene.kmeans(key, pts, k, iters))
    got = tscene.kmeans(None, pts, k, iters,
                        init_idx=_jax_choice(key, len(pts), k), device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * 5)
    if k == 2:
        c = got.numpy()[np.argsort(got.numpy()[:, 0])]
        np.testing.assert_allclose(c[0], [0, 0], atol=0.3)
        np.testing.assert_allclose(c[1], [5, 5], atol=0.3)


def test_kmeans_draws_from_a_generator():
    pts = _clusters()
    a = tscene.kmeans(torch.Generator().manual_seed(4), pts, 2, device=CPU)
    b = tscene.kmeans(torch.Generator().manual_seed(4), pts, 2, device=CPU)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="init_idx"):
        tscene.kmeans(None, pts, 2, device=CPU)


def _bow_sets(rng, count):
    modes = {0: ([0, 0], [3, 0]), 1: ([0, 3], [3, 3])}
    sets, labels = [], []
    for label, (m1, m2) in modes.items():
        for _ in range(count):
            sets.append(np.concatenate([rng.normal(m1, 0.2, (20, 2)),
                                        rng.normal(m2, 0.2, (20, 2))]))
            labels.append(label)
    return sets, labels


def test_bow_train_assign_and_classify():
    """The reference test's sets (tests/test_scene_tld.py:21-40)."""
    rng = np.random.default_rng(1)
    train, labels = _bow_sets(rng, 6)
    key = jax.random.PRNGKey(1)
    jclf = jscene.train_bow(key, train, labels, vocab_size=8,
                            num_neighbors=3)
    idx = _jax_choice(key, sum(len(f) for f in train), 8)
    tclf = tscene.train_bow(None, train, labels, vocab_size=8,
                            num_neighbors=3, init_idx=idx, device=CPU)
    np.testing.assert_allclose(tclf.vocabulary.numpy(), jclf.vocabulary,
                               rtol=0, atol=3e-5)
    np.testing.assert_array_equal(tclf.train_hists.numpy(),
                                  np.asarray(jclf.train_hists))
    test, test_labels = _bow_sets(rng, 5)
    correct = 0
    for f, label in zip(test, test_labels):
        # assignments against one vocabulary, away from near-ties
        v = np.asarray(jclf.vocabulary)
        d = ((f[:, None, :] - v[None]) ** 2).sum(-1)
        part = np.sort(d, 1)
        clear = part[:, 1] - part[:, 0] > 1e-4
        jw = np.asarray(jscene.assign_words(f, v))
        tw = tscene.assign_words(f, torch.tensor(v)).numpy()
        np.testing.assert_array_equal(tw[clear], jw[clear])
        np.testing.assert_array_equal(
            tscene.word_histogram(f, torch.tensor(v)).numpy(),
            np.asarray(jscene.word_histogram(f, v)))
        pred = tscene.classify_bow(tclf, f)
        assert pred == int(jscene.classify_bow(jclf, f))
        correct += int(pred == label)
    assert correct >= 9


def test_classify_bow_ties_keep_training_order():
    """Equal distances: the stable sort keeps the earlier training row in
    both packages; a 1-1 vote goes to the lower label."""
    vocab = np.eye(4, dtype=np.float32) * 10
    hists = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 0],
                      [1, 0, 0, 0]], np.float32)
    feats = np.array([[10.0, 0, 0, 0]])
    for labels, k in (([2, 0, 1, 0], 1), ([0, 1, 0, 1], 1),
                      ([1, 0, 2, 0], 2), ([3, 3, 0, 1], 3)):
        jclf = jscene.BowClassifier(jnp.asarray(vocab), jnp.asarray(hists),
                                    jnp.asarray(labels, jnp.int32), k)
        tclf = tscene.classifier_from_numpy(jclf._asdict(), device=CPU)
        want = int(jscene.classify_bow(jclf, feats))
        assert tscene.classify_bow(tclf, feats) == want, labels
    assert tscene.classify_bow(tscene.classifier_from_numpy(
        {"vocabulary": vocab, "train_hists": hists,
         "train_labels": [2, 0, 1, 0], "num_neighbors": 1},
        device=CPU), feats) == 2


# --- DeepBoof --------------------------------------------------------------

def _close_logits(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * scale)


def test_vgg_forward_from_reference_params():
    p = jdb.init_vgg_cifar10(jax.random.PRNGKey(0))
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (4, 32, 32, 3)))
    want = jdb.vgg_cifar10_forward(p, jnp.asarray(x))
    tp = tdb.params_from_numpy(p, device=CPU)
    assert tp["conv0_0_w"].shape == (64, 3, 3, 3)       # OIHW
    got = tdb.vgg_cifar10_forward(tp, torch.from_numpy(x))
    assert got.shape == (4, 10)
    _close_logits(got.numpy(), want)


@pytest.mark.parametrize("size", [64, 67, 37])
def test_nin_forward_same_padding(size):
    """NIN's 11x11 stride-4 SAME convolution pads asymmetrically (3 before
    and 4 after at 64 px); odd sizes pad otherwise."""
    ch = (16, 24, 32)
    p = jdb.init_nin(jax.random.PRNGKey(2), num_classes=12, channels=ch)
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)
                                            ).astype(np.float32)
    want = jdb.nin_forward(p, jnp.asarray(x), channels=ch)
    got = tdb.nin_forward(tdb.params_from_numpy(p, device=CPU),
                          torch.from_numpy(x), channels=ch)
    assert got.shape == (2, 12)
    _close_logits(got.numpy(), want)
    assert tdb._same_pads(224, 11, 4) == (3, 4)
    assert tdb._same_pads(64, 11, 4) == (3, 4)
    assert tdb._same_pads(size, 3, 1) == (1, 1)


def test_loss_gradient_matches_jax_grad():
    p = jdb.init_vgg_cifar10(jax.random.PRNGKey(0), num_classes=4)
    x = np.random.default_rng(7).uniform(0, 1, (4, 32, 32, 3)
                                         ).astype(np.float32)
    y = np.array([0, 1, 2, 3])

    def jloss(q):
        lg = jdb.vgg_cifar10_forward(q, jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(4), y])
    jg = tdb.params_from_numpy(jax.grad(jloss)(p), device=CPU)
    tp = {k: v.requires_grad_(True)
          for k, v in tdb.params_from_numpy(p, device=CPU).items()}
    loss = torch.nn.functional.cross_entropy(
        tdb.vgg_cifar10_forward(tp, torch.from_numpy(x)),
        torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(jloss(p)),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, list(tp.values()))
    for k, got in zip(tp, grads):
        want = jg[k]
        scale = float(want.abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_npz_round_trip_across_packages(tmp_path):
    p = jdb.init_nin(jax.random.PRNGKey(5), num_classes=7, channels=(8, 8, 8))
    x = np.random.default_rng(8).uniform(0, 1, (1, 48, 48, 3)
                                         ).astype(np.float32)
    want = np.asarray(jdb.nin_forward(p, jnp.asarray(x), channels=(8, 8, 8)))
    jpath = str(tmp_path / "jax.npz")
    jdb.save_params(jpath, p)
    tp = tdb.load_params(jpath, device=CPU)
    _close_logits(tdb.nin_forward(tp, torch.from_numpy(x),
                                  channels=(8, 8, 8)).numpy(), want)
    tpath = str(tmp_path / "torch.npz")
    tdb.save_params(tpath, tp)
    back = jdb.load_params(tpath)
    assert set(back) == set(p)
    for k in p:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(p[k]))


def test_vgg_overfit_drives_the_loss_down():
    """The reference test's trainability smoke test (12 SGD steps)."""
    from boofcv_tpu_torch.examples.image_classification import overfit
    p = tdb.init_vgg_cifar10(torch.Generator().manual_seed(0), device=CPU)
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    y = torch.arange(4)
    loss = lambda q: float(torch.nn.functional.cross_entropy(
        tdb.vgg_cifar10_forward(q, x), y))
    l0 = loss(p)
    p1, _ = overfit(p, x, y, steps=12)
    assert loss(p1) < 0.8 * l0


def test_classifier_wrapper(tmp_path):
    clf = tdb.ImageClassifierVggCifar10(device=CPU)
    img = np.random.default_rng(0).uniform(0, 255, (32, 32, 3))
    s = clf.scores(img)
    assert s.shape == (1, 10) and abs(s.sum() - 1.0) < 1e-5
    c = clf.classify(img)
    assert 0 <= c < 10
    # 0-255 and 0-1 inputs score the same
    np.testing.assert_allclose(clf.scores(img / 255.0), s, rtol=1e-5)
    path = str(tmp_path / "w.npz")
    tdb.save_params(path, clf.params)
    assert tdb.ImageClassifierVggCifar10(
        tdb.load_params(path, device=CPU)).classify(img) == c
    # the reference's wrapper on the same parameters
    jclf = jdb.ImageClassifierVggCifar10(jdb.load_params(path))
    np.testing.assert_allclose(s, jclf.scores(img), rtol=0, atol=1e-5)


# --- profiling ---------------------------------------------------------------

def test_profiling_utils(tmp_path):
    ma = profiling.MovingAverage(0.9)
    ma.update(10.0)
    assert abs(ma.update(20.0) - 11.0) < 1e-9
    t = profiling.StageTimer()
    t_start = time.perf_counter_ns()
    for _ in range(2):
        with t.stage("a", torch.zeros(3), [torch.ones(2)], {"x": 1}):
            _ = np.zeros(10)
    rep = t.report()
    assert set(rep) == {"a"} and rep["a"] >= 0.0 and t.counts["a"] == 2
    # each stage is a span of its name
    spans = [r for r in profiling.records() if r[4] >= t_start]
    assert [r[0] for r in spans] == ["a", "a"]
    assert all(r[2] is None for r in spans)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


# --- examples ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["tracker_object", "classify_scene_knn",
                                  "image_classification"])
def test_examples_run_on_cpu(name):
    import importlib
    mod = importlib.import_module(f"boofcv_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cpu"]) == 0


def test_slice_imports_no_jax():
    """The slice's modules and examples import torch and numpy, never JAX
    or the JAX package."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["recognition.tld", "recognition.scene", "recognition.deepboof",
            "utils.profiling", "io.image_io", "io.calibration_io",
            "io.points_io", "io.video", "io.visualize",
            "examples.tracker_object", "examples.classify_scene_knn",
            "examples.image_classification"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('boofcv_tpu_torch.' + m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'boofcv_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
