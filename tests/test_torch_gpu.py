"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Marked `gpu`; each test skips when no CUDA device is present. On a GPU
machine: `python -m pytest tests/test_torch_gpu.py -m gpu -q`. K4 is integer
only and must be exact, labels and round counts, in its shared-memory
kernel (224², 37×70) and its global one (291², and 1100×1000 beyond the
int32 packing, where the CPU runs the JAX order's int64 round), also with
unmasked input labels; K5 repeats the twin's arithmetic without fused
multiply-adds and is held bit-equal (`torch.equal`) at every shape, border
tiles and partial tiles included, in one launch with no scratch. K1's
rotation repeats the twin's arithmetic, so its f32 mode equals the twin
exactly; its uint8 mode dequantises by a true division, as the twin now
does (`true_div`), but sums each channel's mean in its own fixed order
where the twin calls `torch.sum`: a mean one ulp apart moves an output by
one ulp of the output, read on an H100 as at most 2^-24 at these tests'
shapes (0.8-4.8% of the values) and 2^-23 in `chip_smoke.py` phase 5, so
f32 out is held at 2^-23, bf16 out at 2^-8 (one bf16 ulp below 1), the
identity at 1e-6. K1
and K2 run one shared-memory kernel
launch where the three-channel uint8 image fits (224², 37×70, 272²) and
their multi-pass kernels beyond (291², 320², other channel counts); both
paths are held, and the controls the
kernels compute from each angle equal `rotation_controls` on the card bit
for bit from -30° to 30° in steps of 1e-3°. One f32 train step on the
card against the CPU (TF32 off), at fixed inputs, for leafcnn-tiny and
resnet10, on the first input draw (seeds 11 to 26) on which both make
the same ReLU and max-pool decisions, so that no value within rounding
of 0 or of a tie sends a gradient elsewhere on one side: loss rtol 1e-4
on both backends; with cuDNN off each gradient within 1e-3 relative L2; with cuDNN on
all gradients together within 1e-3 and each within 1e-2. On an H100 over
draws 11 to 26, the draws with a decision differing read up to 3.4e-3 on
all gradients and 2.8e-2 on one, and every draw without read at most
2.4e-6 and 1.5e-5. K2, K3
and K6 (the balancing rotate, shear and opt-in distortion) repeat their
twins' arithmetic without fused multiply-adds and draw the same Philox
words: K2, K3 and K6 are held exact (`torch.equal`). K3 is one
launch with its controls computed in the kernel, in bands of whole lines
(rows) or tiles of 32 columns (vertical shears), and a simple kernel for
lines too long for shared memory. K6 is one launch that allocates only the
output, a thread-block cluster per image (2 to 16 blocks at 224², picked
per call; every size the pick gives yields the same bytes), or one block
per plane for an image too large for a cluster (700²); edge planes
(constant images whose bins give hi <= lo, cutoffs 0 and 49%, a cut equal
to a cumulative count) are held exact too. resnet18 served in bf16 on the
card (224 px, one 64-batch through the Predictor) against its f32 forward
on the CPU: probabilities within 2e-2. K2 and K3 at the materialising
balancer's source shapes (256², 320², 16×200, 200×16; 1, 5 and 64 images)
exact; strict distortion noise drawn for the card equals the CPU's; the
balancer on the card against the CPU with the same draws: flip, K2, K3,
K6 and strict distortion exact, the eager float ops within 1 LSB. The
transform slice's shapes: K4 and K5 at [16,333,333] and [1,256,256] (K4's
global kernel) exact against their twins on leaf-like and random masks; a
batched Canny is one K5 launch that gives each image its own edges; the
batched masks (default, kmeans, auto, shadow suppression) and the device
GrabCut on the card against the CPU on ≥ 99.9% of pixels. The streamed
train path (`prefetch_to_device`: pinned staging, a side stream, events)
yields the host batches on the card, makes no host sync in a dispatch,
and `fit` on it is bit-equal to the gather path, eager and in a K = 4
graph, cuDNN deterministic. The BatchNorm (+ReLU) kernels
(`csrc/batch_norm.cu`) are held against the plain twin on the card at every
BatchNorm shape of the train cells, a ragged row count and a width that is
not a multiple of 8, in bf16 and f32, channels-last and channels-first
(which the wrapper copies into channels-last and back, counted),
with and without the ReLU (the tolerances are stated in each test: the
statistics' f32 sums run in another order); two calls are bit-equal, and
in a K = 4 graph of resnet18-b128 steps the launch counters equal the
profiler's kernel events. The residual blocks' exit kernels
(`csrc/block_exit.cu`) are held against the twin on the card at every exit
of the train cells and at tiny odd shapes (ties, floored pools, SAME −inf
pads), bf16 and f32: the output and the max-pool's picks bit-equal, dy and
d_shortcut within one rounding step, the SE gate's gradient within its
terms' rounding; two calls are bit-equal, an exit is one forward and one
backward launch, and each train cell's model runs one of each an exit.
The card-against-CPU steps run the exit's twin on both sides
(`_Decisions`), whose ReLU and max-pool decisions they compare. No JAX
here.
"""

import copy
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from leaffliction_tpu_torch.ops.components import _propagate  # noqa: E402
from leaffliction_tpu_torch.ops.kernels.components import (  # noqa: E402
    cc_propagate,
    cc_propagate_plain,
    packs_in_int32,
)
from leaffliction_tpu_torch.ops.kernels.edge import (  # noqa: E402
    edge_nms,
    edge_nms_plain,
)
from leaffliction_tpu_torch.ops.kernels.distortion import (  # noqa: E402
    distortion,
    distortion_plain,
)
from leaffliction_tpu_torch.ops.kernels.rotate import (  # noqa: E402
    rotation_controls,
    rotation_controls_cuda,
    train_aug,
    train_aug_plain,
)
from leaffliction_tpu_torch.ops.kernels.warp import (  # noqa: E402
    rotate_expand,
    rotate_expand_plain,
    shear_cubic,
    shear_cubic_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cc_inputs(cuda, n, h, w, density, seed=5):
    mask = torch.from_numpy(np.random.default_rng(seed).random((n, h, w))
                            < density).to(cuda)
    flat = torch.arange(1, h * w + 1, dtype=torch.int32,
                        device=cuda).reshape(h, w)
    return torch.where(mask, flat, 0).contiguous(), mask


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
@pytest.mark.parametrize("n,h,w,limit", [(8, 224, 224, 448),
                                         (1, 291, 291, 582),
                                         (3, 37, 70, 107),
                                         (8, 224, 224, 1)])
def test_cc_propagate_matches_twin(cuda, n, h, w, limit, density):
    """Labels and per-image rounds exact; limit 1 caps every image at two
    rounds."""
    lab, mask = _cc_inputs(cuda, n, h, w, density)
    got, rounds = cc_propagate(lab, mask, limit)
    ref, ref_rounds = cc_propagate_plain(lab, mask, limit)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(rounds, ref_rounds)
    if limit == 1:
        assert rounds.tolist() == [2] * n


def test_cc_propagate_kernel_choice(cuda):
    """Which image sizes the shared-memory kernel takes."""
    from leaffliction_tpu_torch.kernels import build

    smem = build.load().leaf_cc_propagate_smem_bytes
    assert 0 < smem(224, 224) <= 232448 and smem(37, 70) > 0
    assert smem(291, 291) == smem(256, 256) == smem(1100, 1000) == 0


@pytest.mark.parametrize("h,w", [(224, 224), (291, 291)])
def test_cc_propagate_unmasked_input_labels(cuda, h, w):
    """Labels anywhere in [0, h*w], on the background too: the first
    round's 3x3 max reads them."""
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(rng.random((2, h, w)) < 0.6).to(cuda)
    lab = torch.from_numpy(rng.integers(0, h * w + 1, (2, h, w),
                                        dtype=np.int32)).to(cuda)
    got, rounds = cc_propagate(lab, mask, h + w)
    ref, ref_rounds = cc_propagate_plain(lab, mask, h + w)
    assert torch.equal(got, ref) and torch.equal(rounds, ref_rounds)


def test_cc_propagate_beyond_the_int32_packing(cuda):
    """1100×1000 does not pack in int32: the kernel against its twin (int64
    planes) exactly, and against `_propagate` on the CPU (the int64 round in
    the JAX order), labels exact."""
    assert not packs_in_int32(1100, 1000)
    lab, mask = _cc_inputs(cuda, 1, 1100, 1000, 0.6)
    got, rounds = cc_propagate(lab, mask, 2100)
    ref, ref_rounds = cc_propagate_plain(lab.cpu(), mask.cpu(), 2100)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(rounds.cpu(), ref_rounds)
    assert torch.equal(got.cpu(), _propagate(lab.cpu(), mask.cpu(), 2100))


def test_propagate_is_one_launch_without_host_sync(cuda):
    lab, mask = _cc_inputs(cuda, 2, 224, 224, 0.5)
    torch.cuda.synchronize()
    before = cc_propagate.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _propagate(lab, mask, 448)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cc_propagate.launches == before + 1
    assert torch.equal(out, cc_propagate_plain(lab, mask, 448)[0])


EDGE_SHAPES = [(3, 3), (5, 7), (37, 70), (224, 224), (225, 223)]


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("h,w", EDGE_SHAPES)
def test_edge_nms_matches_twin(cuda, h, w, n, l2):
    """Bit-equal: border tiles take reflected blur taps and wrapped NMS
    neighbours, partial tiles at 225×223, the smallest legal image 3×3."""
    rng = np.random.default_rng(6)
    gray = torch.from_numpy(rng.uniform(0, 255, (n, h, w)).astype(
        np.float32)).to(cuda)
    got = edge_nms(gray, l2)
    ref = edge_nms_plain(gray, l2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got - ref).abs().max().item()


def test_edge_nms_ties_and_flat_regions_match_twin(cuda):
    """Flat patches and repeated steps make equal magnitudes side by side:
    the NMS comparisons must not flip."""
    yy, xx = np.mgrid[0:224, 0:224]
    gray = np.stack([((xx // 8) % 2) * 100.0 + ((yy // 16) % 3) * 40.0,
                     np.where((xx - 112) ** 2 + (yy - 112) ** 2 < 70 ** 2,
                              200.0, 20.0)]).astype(np.float32)
    gray = torch.from_numpy(gray).to(cuda)
    for l2 in (False, True):
        assert torch.equal(edge_nms(gray, l2), edge_nms_plain(gray, l2))


def test_edge_taps_are_the_twins(cuda):
    import ctypes

    from leaffliction_tpu_torch.kernels import build
    from leaffliction_tpu_torch.ops.kernels.edge import G5

    taps = (ctypes.c_float * 5)()
    assert build.load().leaf_edge_taps(taps) == 0
    assert np.array_equal(np.array(taps, np.float32), G5)


def test_wrappers_count_launches(cuda):
    gray = torch.rand(1, 16, 16, device=cuda)
    before = edge_nms.launches
    edge_nms(gray)
    assert edge_nms.launches == before + 1


def _aug_inputs(cuda, n, h, w, seed, c=3):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w, c),
                                         dtype=np.uint8)).to(cuda)
    angles = torch.from_numpy(rng.uniform(-18, 18, n).astype(
        np.float32)).to(cuda)
    factors = torch.from_numpy(rng.uniform(0.9, 1.1, n).astype(
        np.float32)).to(cuda)
    return imgs, angles, factors


SMEM_SHAPES = [(224, 224), (37, 70), (272, 272)]
LARGE_SHAPES = [(291, 291), (320, 320)]


@pytest.mark.parametrize("out_dtype,tol", [(torch.float32, 2.0 ** -23),
                                           (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("h,w", SMEM_SHAPES + LARGE_SHAPES)
def test_train_aug_u8_matches_twin(cuda, h, w, out_dtype, tol):
    imgs, angles, factors = _aug_inputs(cuda, 8, h, w, 7)
    got = train_aug(imgs, angles, factors, out_dtype)
    ref = train_aug_plain(imgs, angles, factors, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == imgs.shape
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("c", [1, 4])
def test_train_aug_u8_other_channel_counts_match_twin(cuda, c):
    """Channel counts other than three take the multi-pass kernels."""
    from leaffliction_tpu_torch.kernels import build

    assert build.load().leaf_train_aug_smem_bytes(64, 48, c) == 0
    imgs, angles, factors = _aug_inputs(cuda, 4, 64, 48, 9, c)
    got = train_aug(imgs, angles, factors)
    ref = train_aug_plain(imgs, angles, factors)
    torch.cuda.synchronize()
    assert got.shape == imgs.shape
    assert (got - ref).abs().max().item() <= 2.0 ** -23


@pytest.mark.parametrize("h,w", SMEM_SHAPES + LARGE_SHAPES[:1])
def test_train_aug_f32_rotation_matches_twin(cuda, h, w):
    imgs, angles, _ = _aug_inputs(cuda, 8, h, w, 8)
    x = imgs.float() / 255.0
    got = train_aug(x, angles)
    ref = train_aug_plain(x, angles)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() == 0.0


def test_rotation_controls_equal_the_twin_bit_for_bit(cuda):
    """The controls K1 and K2 compute in the kernel (tanf, sinf, rintf of
    each angle) against `rotation_controls` in PyTorch on the card, every
    angle from -30° to 30° in steps of 1e-3°."""
    angles = torch.from_numpy((np.arange(-30000, 30001) / 1000.0).astype(
        np.float32)).to(cuda)
    got = rotation_controls_cuda(angles)
    ref = rotation_controls(angles)
    assert got.shape == ref.shape == (6, 60001)
    bad = (got != ref).any(0)
    assert not bad.any(), angles[bad][:8].tolist()


def test_rotation_kernel_choice(cuda):
    """Which shapes take the single-launch shared-memory kernels."""
    from leaffliction_tpu_torch.kernels import build
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    lib = build.load()
    for h, w in SMEM_SHAPES:
        canvas = rotate_canvas_hw(h, w)
        assert 0 < lib.leaf_train_aug_smem_bytes(h, w, 3) <= 232448
        assert 0 < lib.leaf_rotate_expand_smem_bytes(h, w, *canvas) <= 232448
        assert 1 <= lib.leaf_train_aug_blocks_per_image(8, h, w, 3, 1) <= 8
        assert 1 <= lib.leaf_rotate_expand_blocks_per_image(
            8, h, w, *canvas) <= 8
    for h, w in LARGE_SHAPES:
        canvas = rotate_canvas_hw(h, w)
        assert lib.leaf_train_aug_smem_bytes(h, w, 3) == 0
        assert lib.leaf_rotate_expand_smem_bytes(h, w, *canvas) == 0
        assert lib.leaf_train_aug_blocks_per_image(8, h, w, 3, 1) == 0
        assert lib.leaf_rotate_expand_blocks_per_image(8, h, w, *canvas) == 0


def _kernels_of_one_call(fn):
    """(device kernel names, bytes allocated at the peak) of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # the profiler's device tracing can start late
        out = fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    names = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            names += [e.key] * e.count
    return names, peak, out


@pytest.mark.parametrize("n", [1, 8])
def test_edge_nms_is_one_launch_without_scratch(cuda, n):
    gray = torch.rand(n, 224, 224, device=cuda) * 255.0
    names, peak, out = _kernels_of_one_call(lambda: edge_nms(gray))
    assert len(names) == 1 and "edge_nms_tile" in names[0], names
    # the output alone (the allocator rounds to 512 bytes): the
    # three-kernel design added two f32 planes and a byte plane
    assert peak <= out.numel() * 4 + 511


@pytest.mark.parametrize("kernel", ["train_aug_f32", "train_aug_bf16",
                                    "rotate_expand"])
def test_smem_path_is_one_launch_without_scratch(cuda, kernel):
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    imgs, angles, factors = _aug_inputs(cuda, 8, 224, 224, 16)
    if kernel == "rotate_expand":
        canvas = rotate_canvas_hw(224, 224)
        names, peak, out = _kernels_of_one_call(
            lambda: rotate_expand(imgs, angles, canvas))
    else:
        dt = torch.float32 if kernel == "train_aug_f32" else torch.bfloat16
        names, peak, out = _kernels_of_one_call(
            lambda: train_aug(imgs, angles, factors, dt))
    stem = "rotate_expand" if kernel == "rotate_expand" else "train_aug"
    assert len(names) == 1 and f"{stem}_smem" in names[0], names
    # the output alone: the multi-pass scratch would add two f32 canvases
    # (9.6 MB for K1 here, 18 MB for K2)
    assert peak <= out.numel() * out.element_size() + 2 ** 20


@pytest.mark.parametrize("n", [16, 32, 128])
def test_train_aug_cluster_order_is_deterministic(cuda, n):
    """The k blocks of an image (k chosen by the batch size) add their
    channel sums in rank order: two calls are bit-equal."""
    from leaffliction_tpu_torch.kernels import build

    assert build.load().leaf_train_aug_blocks_per_image(n, 224, 224, 3, 0) > 0
    imgs, angles, factors = _aug_inputs(cuda, n, 224, 224, 17)
    a = train_aug(imgs, angles, factors)
    b = train_aug(imgs, angles, factors)
    assert torch.equal(a, b)


def test_train_aug_zero_angle_unit_factor_is_identity(cuda):
    imgs, _, _ = _aug_inputs(cuda, 4, 224, 224, 9)
    got = train_aug(imgs, torch.zeros(4, device=cuda),
                    torch.ones(4, device=cuda))
    assert (got - imgs.float() / 255.0).abs().max().item() <= 1e-6


def test_train_aug_refuses_what_it_does_not_take(cuda):
    imgs, angles, factors = _aug_inputs(cuda, 2, 16, 16, 10)
    with pytest.raises(ValueError):
        train_aug(imgs, angles)                       # uint8, no contrast
    with pytest.raises(ValueError):
        train_aug(imgs.float(), angles, factors)      # f32 with contrast
    with pytest.raises(ValueError):
        train_aug(imgs, angles, factors, torch.float16)
    with pytest.raises(ValueError):
        train_aug(imgs[..., 0], angles, factors)      # not [n, h, w, c]
    before = train_aug.launches
    train_aug(imgs, angles, factors)
    assert train_aug.launches == before + 1


class _Decisions:
    """The discrete decisions of a model's forward, in call order: the
    sign of every ReLU'd output (a BatchNorm called with `relu=True`, a
    residual block's exit `relu(shortcut + y·se)`) and the picks of every
    max-pool (`max_pool2d` stands in for `F.max_pool2d`). The exit runs
    its twin on both sides (`block_exit` stands in for
    `ops.block_exit.block_exit`), so its ReLU and pool are seen as the
    models saw them before the exit was one kernel. Where the card and the
    CPU differ in one of them, a value within rounding of 0 or of a tie
    has sent a gradient elsewhere on one side, which can move gradients by
    up to 3e-2: a comparison of the two steps' arithmetic is then
    ill-posed."""

    def __init__(self, model):
        self.seen, self.pool = [], torch.nn.functional.max_pool2d
        self.hooks = [
            m.register_forward_hook(self.relu_out, with_kwargs=True)
            for m in model.modules() if type(m).__name__ == "BatchNorm"]

    def relu_out(self, module, args, kwargs, out):
        if kwargs.get("relu"):
            self.seen.append(out.detach().gt(0).cpu())

    def block_exit(self, y, se=None, shortcut=None, relu=True, drop=None,
                   pool=None):
        from leaffliction_tpu_torch.ops import block_exit as exits

        x = exits.block_exit_plain(y, se, shortcut, relu)
        if relu:
            self.seen.append(x.detach().gt(0).cpu())
        return exits.block_exit_plain(x, relu=False, drop=drop, pool=pool)

    def max_pool2d(self, x, *args, **kwargs):
        out, idx = self.pool(x, *args, return_indices=True, **kwargs)
        self.seen.append(idx.cpu())
        return out

    def close(self):
        for h in self.hooks:
            h.remove()


DRAW_SEEDS = range(11, 27)


def _step_on_card_and_cpu(cuda, cudnn: bool, arch: str = "leafcnn"):
    """One f32 train step's loss and gradients, on the CPU and the card:
    leafcnn-tiny or resnet10 (dropout off) at 64 px, batch 8, on the
    first input draw of `DRAW_SEEDS` on which the two make the same
    decisions (`_Decisions`)."""
    from unittest import mock

    from leaffliction_tpu_torch.core.device import resolve_device
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN, init_leafcnn
    from leaffliction_tpu_torch.models.resnet import (
        RESNET_PRESETS,
        LeafResNet,
    )
    from leaffliction_tpu_torch.ops import block_exit as exits
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import loss_fn

    resolve_device("cuda")  # TF32 off for convolutions and matmuls
    cfg = TrainConfig.regularized()
    cpu_model = init_leafcnn(LeafCNN(5, (16, 32, 64)) if arch == "leafcnn"
                             else LeafResNet(5, **RESNET_PRESETS[arch],
                                             drop_top=0.0), 0)
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    for seed in DRAW_SEEDS:
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.random((8, 64, 64, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 5, 8))
        mask = torch.ones(8)
        out, seen = {}, {}
        for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda)):
            decisions = _Decisions(model)
            try:
                with torch.backends.cudnn.flags(enabled=cudnn,
                                                allow_tf32=False), \
                        mock.patch.object(torch.nn.functional, "max_pool2d",
                                          decisions.max_pool2d), \
                        mock.patch.object(exits, "block_exit",
                                          decisions.block_exit):
                    loss, _ = loss_fn(model(x.to(dev), train=True),
                                      labels.to(dev), mask.to(dev), 5,
                                      cfg.label_smoothing)
                    grads = torch.autograd.grad(loss,
                                                list(model.parameters()))
            finally:
                decisions.close()
            out[dev] = (loss.item(), [g.cpu().double() for g in grads])
            seen[dev] = decisions.seen
        assert len(seen["cpu"]) == len(seen[cuda]) > 0
        if all(torch.equal(a, b) for a, b in zip(seen["cpu"], seen[cuda])):
            return out["cpu"], out[cuda]
    raise AssertionError(f"the card and the CPU differ in a ReLU or "
                         f"max-pool decision on every draw of {DRAW_SEEDS}")


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def test_train_step_card_matches_cpu(cuda):
    (l_cpu, g_cpu), (l_gpu, g_gpu) = _step_on_card_and_cpu(cuda, False)
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for a, b in zip(g_gpu, g_cpu):
        assert _rel_l2(a, b) <= 1e-3


def test_train_step_card_matches_cpu_with_cudnn(cuda):
    (l_cpu, g_cpu), (l_gpu, g_gpu) = _step_on_card_and_cpu(cuda, True)
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert _rel_l2(torch.cat([a.ravel() for a in g_gpu]),
                   torch.cat([b.ravel() for b in g_cpu])) <= 1e-3
    for a, b in zip(g_gpu, g_cpu):
        assert _rel_l2(a, b) <= 1e-2


@pytest.mark.parametrize("cudnn", [False, True])
def test_resnet10_train_step_card_matches_cpu(cuda, cudnn):
    """resnet10 at the LeafCNN step's bars: loss 1e-4; each gradient 1e-3
    with cuDNN off; all together 1e-3 and each 1e-2 with cuDNN on."""
    (l_cpu, g_cpu), (l_gpu, g_gpu) = _step_on_card_and_cpu(cuda, cudnn,
                                                           "resnet10")
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert _rel_l2(torch.cat([a.ravel() for a in g_gpu]),
                   torch.cat([b.ravel() for b in g_cpu])) <= 1e-3
    for a, b in zip(g_gpu, g_cpu):
        assert _rel_l2(a, b) <= (1e-2 if cudnn else 1e-3)


def test_resnet18_bf16_serving_matches_cpu_f32(cuda):
    """resnet18 at 224 px, bf16 on the card through the Predictor (one
    64-batch), against the f32 forward on the CPU: probabilities within
    2e-2, from seeded lecun-normal weights and non-identity BatchNorm and
    input statistics."""
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.predict.predictor import Predictor

    g = torch.Generator().manual_seed(17)
    cpu_model = build_resnet(8, "resnet18")
    sd = {}
    for key, ref in cpu_model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight":
            std = (0.3 if "Dense" in key else 1.0) / ref[0].numel() ** 0.5
            sd[key] = torch.randn(ref.shape, generator=g) * std
        elif leaf in ("var", "scale") or key == "norm_var":
            lo = 0.05 if key == "norm_var" else 0.5
            sd[key] = lo + torch.rand(ref.shape, generator=g)
        else:
            sd[key] = 0.1 * torch.randn(ref.shape, generator=g)
    cpu_model.load_state_dict(sd)
    card = build_resnet(8, "resnet18", dtype=torch.bfloat16)
    card.load_state_dict(sd)
    images = np.random.default_rng(18).integers(0, 256, (64, 224, 224, 3),
                                                dtype=np.uint8)
    probs = Predictor.from_model(card, [str(i) for i in range(8)], 224,
                                 cuda)._probs_for_arrays(images)
    assert probs.shape == (64, 8) and np.isfinite(probs).all()
    with torch.no_grad():
        ref = torch.softmax(cpu_model.eval()(
            torch.from_numpy(images[:8]).float() / 255.0), -1).numpy()
    assert np.abs(probs[:8] - ref).max() <= 2e-2


def _u8(cuda, n, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng, torch.from_numpy(rng.integers(0, 256, (n, h, w, 3),
                                              dtype=np.uint8)).to(cuda)


def _lsb(got, ref):
    return (got.int() - ref.int()).abs().max().item()


@pytest.mark.parametrize("h,w", SMEM_SHAPES + LARGE_SHAPES[:1])
def test_rotate_expand_matches_twin(cuda, h, w):
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    rng, imgs = _u8(cuda, 8, h, w, 12)
    angles = torch.from_numpy(rng.uniform(-30, 30, 8).astype(
        np.float32)).to(cuda)
    canvas = rotate_canvas_hw(h, w)
    before = rotate_expand.launches
    got = rotate_expand(imgs, angles, canvas)
    ref = rotate_expand_plain(imgs, angles, canvas)
    torch.cuda.synchronize()
    assert rotate_expand.launches == before + 1
    assert got.shape == (8, *canvas, 3) and got.dtype == torch.uint8
    assert torch.equal(got, ref), _lsb(got, ref)


@pytest.mark.parametrize("n", [1, 8, 18, 64, 128])
@pytest.mark.parametrize("h,w", [(224, 224), (37, 70), (31, 45), (5, 3)])
def test_shear_cubic_matches_twin(cuda, h, w, n):
    """Exact, both directions in one call, s = 0 an exact identity; n sets
    the bands an image takes (one line a band at n = 1)."""
    from leaffliction_tpu_torch.kernels import build

    assert build.load().leaf_shear_cubic_blocks_per_image(n, h, w) >= 1
    rng, imgs = _u8(cuda, n, h, w, 13)
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
        np.float32)).to(cuda)
    shears[0] = 0.0
    horiz = torch.from_numpy(np.arange(n) % 2 == 0).to(cuda)
    before = shear_cubic.launches
    got = shear_cubic(imgs, shears, horiz)
    ref = shear_cubic_plain(imgs, shears, horiz)
    torch.cuda.synchronize()
    assert shear_cubic.launches == before + 1
    assert torch.equal(got, ref), _lsb(got, ref)
    assert torch.equal(got[0], imgs[0])


def test_shear_cubic_unaligned_views_match_twin(cuda):
    """Inputs and outputs at addresses off 16 bytes: the bands' 16-byte
    loads and stores start mid-run."""
    rng, imgs = _u8(cuda, 7, 37, 70, 21)
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, 6).astype(
        np.float32)).to(cuda)
    horiz = torch.tensor([True, False, False, True, True, False],
                         device=cuda)
    view = imgs[1:]  # 37·70·3 bytes past the allocation
    got = shear_cubic(view, shears, horiz)
    assert torch.equal(got, shear_cubic_plain(view, shears, horiz))


@pytest.mark.parametrize("n", [1, 18])
@pytest.mark.parametrize("h,w", [(224, 224), (37, 70)])
def test_shear_cubic_steep_shears_match_twin(cuda, h, w, n):
    """|s| in (1, 2], beyond the balancing op's 0.2: at 224² a vertical
    tile's taps then reach past the rows it stages, and it reads them from
    global memory. Held exact, mostly vertical, both signs."""
    rng, imgs = _u8(cuda, n, h, w, 25)
    mag = 2.0 - rng.uniform(0.0, 1.0, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    shears = torch.from_numpy((sign * mag).astype(np.float32)).to(cuda)
    horiz = torch.from_numpy(np.arange(n) % 3 == 2).to(cuda)
    got = shear_cubic(imgs, shears, horiz)
    ref = shear_cubic_plain(imgs, shears, horiz)
    assert torch.equal(got, ref), _lsb(got, ref)


def test_shear_cubic_long_lines_take_the_simple_kernel(cuda):
    """A line longer than shared memory holds runs the simple kernel."""
    from leaffliction_tpu_torch.kernels import build

    lib = build.load()
    assert lib.leaf_shear_cubic_smem_bytes(3, 40000) == 0
    assert lib.leaf_shear_cubic_blocks_per_image(2, 3, 40000) == 0
    assert 0 < lib.leaf_shear_cubic_smem_bytes(224, 224) <= 232448
    rng, imgs = _u8(cuda, 2, 3, 40000, 22)
    shears = torch.tensor([0.17, -0.2], device=cuda)
    horiz = torch.tensor([True, False], device=cuda)
    names, _, got = _kernels_of_one_call(
        lambda: shear_cubic(imgs, shears, horiz))
    assert len(names) == 1 and "shear_cubic_simple" in names[0], names
    assert torch.equal(got, shear_cubic_plain(imgs, shears, horiz))


@pytest.mark.parametrize("n", [18, 64])
def test_shear_cubic_is_one_launch_without_scratch(cuda, n):
    rng, imgs = _u8(cuda, n, 224, 224, 23)
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
        np.float32)).to(cuda)
    horiz = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    names, peak, out = _kernels_of_one_call(
        lambda: shear_cubic(imgs, shears, horiz))
    assert len(names) == 1 and "shear_cubic_band" in names[0], names
    # the output alone (the allocator rounds to 512 bytes): no controls
    # tensor, no converted flags
    assert peak <= out.numel() + 511


def test_shear_controls_equal_the_twin_bit_for_bit(cuda):
    """The split K3 computes in the kernel against `shear_controls` in
    PyTorch on the card, every s from -0.2 to 0.2 in steps of 1e-4."""
    from leaffliction_tpu_torch.ops.kernels.warp import (
        shear_controls,
        shear_controls_cuda,
    )

    s = torch.from_numpy((np.arange(-2000, 2001) / 1e4).astype(
        np.float32)).to(cuda)
    got, ref = shear_controls_cuda(s), shear_controls(s)
    assert got.shape == ref.shape == (3, 4001)
    bad = (got != ref).any(0)
    assert not bad.any(), s[bad][:8].tolist()


def test_k3_and_k5_calls_are_deterministic(cuda):
    rng, imgs = _u8(cuda, 64, 224, 224, 24)
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, 64).astype(
        np.float32)).to(cuda)
    horiz = torch.from_numpy(rng.random(64) < 0.5).to(cuda)
    assert torch.equal(shear_cubic(imgs, shears, horiz),
                       shear_cubic(imgs, shears, horiz))
    gray = imgs[:8, ..., 0].float()
    for l2 in (False, True):
        assert torch.equal(edge_nms(gray, l2), edge_nms(gray, l2))


def _k6_inputs(cuda, n, h, w, seed, cut_hi=2.0):
    rng, imgs = _u8(cuda, n, h, w, seed)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 3),
                                          dtype=np.int64)).to(cuda)
    cutoffs = torch.from_numpy(rng.uniform(0, cut_hi, n).astype(
        np.float32)).to(cuda)
    return imgs, seeds, cutoffs


# (n, h, w): 224² at the batch sizes of one image, the opt-in command's own
# call, the fused chunk and two chunks; odd and larger shapes; 700² takes
# the simple kernel (a 16th of it does not fit in a block's registers and
# shared memory)
K6_SHAPES = [(1, 224, 224), (18, 224, 224), (64, 224, 224), (128, 224, 224),
             (8, 224, 224), (8, 37, 70), (2, 256, 256), (1, 600, 600),
             (1, 700, 700)]


@pytest.mark.parametrize("n,h,w", K6_SHAPES)
def test_distortion_matches_twin(cuda, n, h, w):
    from leaffliction_tpu_torch.kernels import build

    imgs, seeds, cutoffs = _k6_inputs(cuda, n, h, w, 14)
    lib = build.load()
    simple = lib.leaf_distortion_smem_bytes(h, w) == 0
    assert simple == (h * w > 436864)
    assert (lib.leaf_distortion_blocks_per_image(n, h, w) == 0) == simple
    before = distortion.launches
    got = distortion(imgs, seeds, cutoffs)
    ref = distortion_plain(imgs, seeds, cutoffs)
    torch.cuda.synchronize()
    assert distortion.launches == before + 1
    assert torch.equal(got, ref), _lsb(got, ref)


def _k6_noisy(imgs, seeds):
    from leaffliction_tpu_torch.ops.kernels.distortion import (
        irwin_hall_noise,
    )

    h, w = imgs.shape[1:3]
    return torch.clamp(imgs.float() + 5.0 * irwin_hall_noise(seeds, h, w),
                       0.0, 255.0)


@pytest.mark.parametrize("fill,cutoff", [(0, 49.0), (255, 49.0), (0, 0.0),
                                         (128, 0.0), (128, 49.0)])
def test_distortion_edge_planes_match_twin(cuda, fill, cutoff):
    """Constant images (at 0 and 255 the clip piles half the noisy values
    on one bin, so with cutoff 49% hi <= lo and x passes through), and the
    cutoffs 0 and 49%."""
    from leaffliction_tpu_torch.ops.photometric import (
        cutoff_bins,
        cutoff_count,
    )

    _, seeds, _ = _k6_inputs(cuda, 4, 224, 224, 26)
    imgs = torch.full((4, 224, 224, 3), fill, dtype=torch.uint8, device=cuda)
    cutoffs = torch.full((4,), cutoff, device=cuda)
    got = distortion(imgs, seeds, cutoffs)
    assert torch.equal(got, distortion_plain(imgs, seeds, cutoffs))
    lo, hi = cutoff_bins(torch.round(_k6_noisy(imgs, seeds)),
                         cutoff_count(cutoffs, 224 * 224, cuda))
    if fill in (0, 255) and cutoff == 49.0:
        assert bool((hi <= lo).all())  # the pass-through branch ran


def test_distortion_cut_on_a_cumulative_count_matches_twin(cuda):
    """A cutoff whose cut equals the cumulative count at a bin of the noisy
    plane exactly: that bin counts as within the cut (lo moves past it)."""
    from leaffliction_tpu_torch.ops.photometric import (
        cutoff_bins,
        cutoff_count,
    )

    imgs, seeds, _ = _k6_inputs(cuda, 1, 100, 100, 27)
    q = torch.round(_k6_noisy(imgs, seeds))[0, ..., 0].long()
    cdf = torch.bincount(q.reshape(-1), minlength=256).cumsum(0).cpu()
    tie = None
    for v in range(256):
        c = int(cdf[v])
        if 0 < c < 4000:
            cutoff = torch.tensor([np.float32(c / 100.0)])
            if float(cutoff_count(cutoff, 10000, "cpu")[0]) == c:
                tie = (v, cutoff.to(cuda))
                break
    assert tie is not None
    v, cutoffs = tie
    lo, _ = cutoff_bins(torch.round(_k6_noisy(imgs, seeds)),
                        cutoff_count(cutoffs, 10000, cuda))
    assert int(lo[0, 0]) > v
    got = distortion(imgs, seeds, cutoffs)
    assert torch.equal(got, distortion_plain(imgs, seeds, cutoffs))


def test_distortion_every_picked_cluster_size_matches_twin(cuda):
    """The output does not depend on the split: for each cluster size the
    pick gives at some image count (1 to 132 images of 224² or 160²), the
    first such count gives the twin's bytes. One image takes a size above 8
    (non-portable) and a full chunk of 224² a small one."""
    from leaffliction_tpu_torch.kernels import build

    lib = build.load()
    first = {}
    for h in (224, 160):
        for n in range(1, 133):
            first.setdefault(lib.leaf_distortion_blocks_per_image(n, h, h),
                             (n, h))
    assert min(first) >= 1 and max(first) > 8 and len(first) >= 4, first
    for k, (n, h) in sorted(first.items()):
        imgs, seeds, cutoffs = _k6_inputs(cuda, n, h, h, 28 + k)
        got = distortion(imgs, seeds, cutoffs)
        ref = distortion_plain(imgs, seeds, cutoffs)
        assert torch.equal(got, ref), (k, n, h, _lsb(got, ref))


@pytest.mark.parametrize("n", [18, 64])
def test_distortion_is_one_launch_without_scratch(cuda, n):
    imgs, seeds, cutoffs = _k6_inputs(cuda, n, 224, 224, 29)
    names, peak, out = _kernels_of_one_call(
        lambda: distortion(imgs, seeds, cutoffs))
    assert len(names) == 1 and "distortion_cluster" in names[0], names
    # the output alone (the allocator rounds to 512 bytes): no converted
    # seeds, no scratch plane
    assert peak <= out.numel() + 511


@pytest.mark.parametrize("n", [1, 18, 64])
def test_distortion_launch_is_the_reported_split(cuda, n, tmp_path):
    """The launch's grid, block and shared memory (the profiler's trace)
    are those `leaf_distortion_blocks_per_image` and
    `leaf_distortion_smem_bytes` describe: 512 threads a block, each
    keeping 16 pixels' x in registers, the band's other pixels' x (12
    bytes each) and the histograms (3,104 bytes) in shared memory."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from leaffliction_tpu_torch.kernels import build

    lib = build.load()
    k = lib.leaf_distortion_blocks_per_image(n, 224, 224)
    most = lib.leaf_distortion_smem_bytes(224, 224)
    assert 2 <= k <= 16 and 0 < most <= 232448
    imgs, seeds, cutoffs = _k6_inputs(cuda, n, 224, 224, 30)
    distortion(imgs, seeds, cutoffs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        distortion(imgs, seeds, cutoffs)
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if "distortion_cluster" in e.get("name", "")
              and "grid" in e.get("args", {})]
    assert len(events) == 1, len(events)
    args = events[0]["args"]
    spilled = max(0, -(-224 * 224 // k) - 16 * 512)
    assert list(args["grid"]) == [n * k, 1, 1]
    assert list(args["block"])[0] == 512
    assert args["shared memory"] == 3104 + 12 * spilled <= most


@pytest.mark.parametrize("n", [18, 64])
def test_distortion_calls_are_deterministic(cuda, n):
    imgs, seeds, cutoffs = _k6_inputs(cuda, n, 224, 224, 31)
    assert torch.equal(distortion(imgs, seeds, cutoffs),
                       distortion(imgs, seeds, cutoffs))


def test_balance_kernels_refuse_what_they_do_not_take(cuda):
    _, imgs = _u8(cuda, 2, 16, 16, 15)
    with pytest.raises(ValueError):
        rotate_expand(imgs.float(), torch.zeros(2, device=cuda), (24, 24))
    with pytest.raises(ValueError):
        rotate_expand(imgs, torch.zeros(2, device=cuda), (8, 8))
    with pytest.raises(ValueError):
        shear_cubic(imgs[..., :1], torch.zeros(2, device=cuda),
                    torch.ones(2, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        distortion(imgs, torch.zeros((2, 2), dtype=torch.int64,
                                     device=cuda), torch.zeros(2,
                                                               device=cuda))


# the materialising balancer's shapes: the reference dataset's 256², a
# source beyond K2's shared-memory limit (320²) and the odd aspect ratios
NATIVE_SHAPES = [(256, 256), (320, 320), (16, 200), (200, 16)]


@pytest.mark.parametrize("n", [1, 5, 18, 20, 64])
@pytest.mark.parametrize("h,w", NATIVE_SHAPES)
def test_k2_and_k3_at_native_shapes_match_twins(cuda, h, w, n):
    """The group sizes the balancer gives (up to 64 at 256², 18 and 20 on
    the north-star tree, 1-5 at odd shapes): K2 on its canvas and K3, both
    directions, exact."""
    from leaffliction_tpu_torch.ops.augment import rotate_canvas_hw

    rng, imgs = _u8(cuda, n, h, w, 40 + n)
    angles = torch.from_numpy(rng.uniform(-30, 30, n).astype(
        np.float32)).to(cuda)
    canvas = rotate_canvas_hw(h, w)
    got = rotate_expand(imgs, angles, canvas)
    ref = rotate_expand_plain(imgs, angles, canvas)
    assert got.shape == (n, *canvas, 3)
    assert torch.equal(got, ref), _lsb(got, ref)
    shears = torch.from_numpy(rng.uniform(-0.2, 0.2, n).astype(
        np.float32)).to(cuda)
    horiz = torch.from_numpy(np.arange(n) % 2 == 0).to(cuda)
    got = shear_cubic(imgs, shears, horiz)
    ref = shear_cubic_plain(imgs, shears, horiz)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), _lsb(got, ref)


def test_strict_noise_is_the_same_on_the_card(cuda, monkeypatch):
    """Strict table indices are drawn on the CPU for any device: the same
    generators give the same noise, cutoffs and strict bytes on the card as
    on the CPU."""
    from leaffliction_tpu_torch.ops.augment import (
        distortion_batch,
        draw_distortion,
    )

    monkeypatch.setenv("LEAF_STRICT_DISTORTION", "1")

    def rngs():
        return [np.random.default_rng([5, i]) for i in range(4)]

    on_card = draw_distortion(rngs(), (64, 72), cuda)
    on_cpu = draw_distortion(rngs(), (64, 72), torch.device("cpu"))
    assert on_card["noise"].is_cuda
    assert torch.equal(on_card["noise"].cpu(), on_cpu["noise"])
    assert torch.equal(on_card["cutoffs"].cpu(), on_cpu["cutoffs"])
    _, imgs = _u8(cuda, 4, 64, 72, 44)
    got = distortion_batch(imgs, **on_card)
    ref = distortion_batch(imgs.cpu(), **on_cpu)
    assert torch.equal(got.cpu(), ref)


def _balance_tree(root):
    from PIL import Image

    rng = np.random.default_rng(46)
    sizes = [(256, 256), (72, 96), (200, 16)]
    for cls, n in {"big": 12, "small": 4}.items():
        d = root / "Plant" / cls
        d.mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(d / f"i{i}.jpg", quality=90)
    return root / "Plant"


@pytest.mark.parametrize("mode", ["default", "LEAF_PALLAS_DISTORT",
                                  "LEAF_STRICT_DISTORTION"])
def test_balancer_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                          mode):
    """The same task list and parameters (drawn on the CPU) on the card and
    on the CPU: flip, rotate (K2) and shear (K3) exact, distortion exact
    through K6 and in strict mode; skew, crop and default distortion, eager
    float ops, within 1 LSB."""
    from leaffliction_tpu_torch.data.balancer import (
        DatasetBalancer,
        task_rngs,
    )
    from leaffliction_tpu_torch.ops.augment import DRAWS

    for name in ("LEAF_PALLAS_DISTORT", "LEAF_STRICT_DISTORTION"):
        monkeypatch.delenv(name, raising=False)
    if mode != "default":
        monkeypatch.setenv(mode, "1")
    _balance_tree(tmp_path / "tree")

    def draw(transform, tasks, hw, device):
        return DRAWS[transform](task_rngs(7, tasks), hw,
                                torch.device("cpu"))

    runs = {}
    for dev in ("cuda", "cpu"):
        arrays = {}
        DatasetBalancer(tmp_path / "tree", tmp_path / f"out_{dev}", seed=7,
                        manifest_out_dir=tmp_path / f"m_{dev}", device=dev,
                        draw=draw, on_array=lambda t, a: arrays.__setitem__(
                            t.output_path.name, np.array(a))).run()
        runs[dev] = arrays
    assert set(runs["cuda"]) == set(runs["cpu"]) and len(runs["cpu"]) == 8
    exact = {"flip", "rotate", "shear"} | (
        {"distortion"} if mode != "default" else set())
    for name, ref in runs["cpu"].items():
        got = runs["cuda"][name]
        assert got.shape == ref.shape, name
        d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        op = name.split("_aug_")[1].rsplit("_", 1)[0]
        if op in exact:
            assert d.max() == 0, (name, d.max())
        else:
            assert d.max() <= 1, (name, d.max())


def _leaf_masks(n, size, seed=3):
    """Leaf-like candidate masks: an ellipse, holes and speckle."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = []
    for _ in range(n):
        cy, cx = size / 2 + rng.normal(0, 6), size / 2 + rng.normal(0, 6)
        blob = (((yy - cy) / (size * 0.32)) ** 2
                + ((xx - cx) / (size * 0.38)) ** 2) < 1
        out.append((blob & (rng.random((size, size)) > 0.05))
                   | (rng.random((size, size)) < 0.02))
    return np.stack(out)


@pytest.mark.parametrize("n,size", [(16, 333), (1, 256)])
def test_cc_propagate_at_the_transform_shapes_matches_twin(cuda, n, size):
    """The transform slice's shapes, a folder chunk of 333² masks and one
    256² filter mask, both past the shared-memory kernel's limit: leaf-like
    masks and density 0.5, labels and rounds exact."""
    from leaffliction_tpu_torch.kernels import build

    assert build.load().leaf_cc_propagate_smem_bytes(size, size) == 0
    flat = torch.arange(1, size * size + 1, dtype=torch.int32,
                        device=cuda).reshape(size, size)
    for masks in (_leaf_masks(n, size),
                  np.random.default_rng(n).random((n, size, size)) < 0.5):
        mask = torch.from_numpy(masks).to(cuda)
        lab = torch.where(mask, flat, 0).contiguous()
        got, rounds = cc_propagate(lab, mask, 2 * size)
        ref, ref_rounds = cc_propagate_plain(lab, mask, 2 * size)
        assert torch.equal(got, ref) and torch.equal(rounds, ref_rounds)


@pytest.mark.parametrize("n,size", [(16, 333), (1, 256)])
@pytest.mark.parametrize("l2", [False, True])
def test_edge_nms_at_the_transform_shapes_matches_twin(cuda, n, size, l2):
    rng = np.random.default_rng(size)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    gray = np.stack([(xx * (2 + i) + yy * 3) % 180
                     + rng.normal(0, 5, (size, size)) for i in range(n)])
    g = torch.from_numpy(gray.astype(np.float32)).to(cuda)
    assert torch.equal(edge_nms(g, l2), edge_nms_plain(g, l2))


@pytest.mark.parametrize("hysteresis", [False, True])
def test_canny_batch_equals_each_image_on_the_card(cuda, hysteresis):
    """One K5 launch for a chunk gives each image its own edges."""
    from leaffliction_tpu_torch.ops.filters import canny

    rng = np.random.default_rng(9)
    gray = torch.from_numpy((_leaf_masks(4, 333).astype(np.float32) * 120
                             + rng.normal(0, 9, (4, 333, 333))
                             ).astype(np.float32)).to(cuda)
    before = edge_nms.launches
    batch = canny(gray, 30, 100, l2=True, hysteresis=hysteresis)
    assert edge_nms.launches == before + 1
    for i in range(4):
        assert torch.equal(batch[i], canny(gray[i], 30, 100, l2=True,
                                           hysteresis=hysteresis))


def test_mask_batch_on_the_card_matches_the_cpu(cuda):
    """The folder path's masks at 333² (the 1.3× upscale of 256² leaves):
    card against CPU on ≥ 99.9% of pixels, one K4 launch a `_propagate`
    for the whole chunk."""
    from leaffliction_tpu_torch.ops.image import resize
    from leaffliction_tpu_torch.segment.config import TransformConfig
    from leaffliction_tpu_torch.segment.mask import make_mask_batch

    x = resize(torch.from_numpy(_leaf_images(4, 256)), (4, 333, 333, 3),
               "cubic")
    cfg = TransformConfig(grabcut_refine=False)
    got, scores = make_mask_batch(x.to(cuda), cfg)
    ref, ref_scores = make_mask_batch(x, cfg)
    assert (got.cpu() == ref).float().mean() >= 0.999
    assert torch.allclose(scores.cpu(), ref_scores, atol=2e-3)


def _leaf_images(n, size, seed=4):
    rng = np.random.default_rng(seed)
    leaves = _leaf_masks(n, size, seed)
    imgs = np.where(leaves[..., None], np.array([60, 150, 50], np.uint8),
                    np.uint8(235)).astype(np.uint8)
    return np.clip(imgs + rng.normal(0, 4, imgs.shape), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("fields", [{"mask_strategy": "kmeans"},
                                    {"mask_strategy": "auto"},
                                    {"shadow_suppression": True}])
def test_kmeans_strategies_on_the_card_match_the_cpu(cuda, fields):
    """The strategies that run k-means (its initial centres drawn on the
    CPU for both) and shadow suppression, card against CPU at 256²."""
    from leaffliction_tpu_torch.segment.config import TransformConfig
    from leaffliction_tpu_torch.segment.mask import make_mask_batch

    x = torch.from_numpy(_leaf_images(2, 256))
    cfg = TransformConfig(grabcut_refine=False, **fields)
    got, scores = make_mask_batch(x.to(cuda), cfg)
    ref, ref_scores = make_mask_batch(x, cfg)
    assert (got.cpu() == ref).float().mean() >= 0.999
    assert torch.allclose(scores.cpu(), ref_scores, atol=2e-3)


def test_device_grabcut_on_the_card_matches_the_cpu(cuda):
    from leaffliction_tpu_torch.segment.grabcut import grabcut_refine

    img = torch.from_numpy(_leaf_images(1, 333)[0]).float()
    mask = torch.from_numpy(_leaf_masks(1, 333, seed=8)[0])
    got = grabcut_refine(img.to(cuda), mask.to(cuda)).cpu()
    ref = grabcut_refine(img, mask)
    assert (got == ref).float().mean() >= 0.999


# --- resume checkpoints and the library warps on the card -----------------


def _tiny_train_state(cuda):
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train.steps import create_train_state

    return create_train_state(LeafCNN(5, (16, 32, 64)), 0, cuda)


def test_maybe_save_does_not_sync(cuda, tmp_path):
    """`maybe_save` on CUDA tensors neither synchronises (sync debug mode
    "error" raises on any sync) nor waits for queued work: after a first
    save (which loads the copy kernels), it returns while a ~0.2 s sleep
    kernel still runs, and the checkpoint committed after it holds the
    state as it was when the snapshot was queued."""
    from leaffliction_tpu_torch.train import checkpoint as ck

    state = _tiny_train_state(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    torch.rand(4, device=cuda, generator=gen)
    saver = ck.AsyncStepCheckpointer(tmp_path, every_steps=1)
    meta = {"epoch": 0, "step_in_epoch": 1, "history": {}}
    assert saver.maybe_save(1, state, meta, gen)
    saver._inflight.result(timeout=60)
    want = {k: v.cpu().clone() for k, v in state.mu.items()}
    torch.cuda.synchronize()
    try:
        torch.cuda._sleep(int(2e8))  # ~0.1-0.2 s of device time
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert saver.maybe_save(2, state, meta, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        took = time.perf_counter() - t0
        for v in state.mu.values():  # the next step's in-place update
            v.add_(1.0)
        assert took < 0.05, f"maybe_save took {took:.3f}s"
    finally:
        saver.close()
    fresh = _tiny_train_state(cuda)
    _, gen_state = ck.restore_resume_checkpoint(tmp_path, 2, fresh)
    for k, v in want.items():
        assert torch.equal(fresh.mu[k].cpu(), v)
    assert torch.equal(gen_state, gen.get_state())


def test_resumed_step_equals_uninterrupted_on_the_card(cuda, tmp_path):
    """Two f32 train steps with K1 and dropout on (cuDNN deterministic),
    against one step, a checkpoint restored into a fresh state and its
    generator, and the second step: every tensor of the state exact."""
    from leaffliction_tpu_torch.train import checkpoint as ck
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import build_step_fns

    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 8, 64, 64, 3),
                                         dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 5, (2, 8))).to(cuda)
    mask = torch.ones(8, device=cuda)
    fns = build_step_fns(TrainConfig.regularized(), 5, 100)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        ref = _tiny_train_state(cuda)
        gen = torch.Generator(device=cuda).manual_seed(7)
        for i in range(2):
            fns.train_step(ref, imgs[i], labels[i], mask, gen)
        ref_gen = gen.get_state()

        first = _tiny_train_state(cuda)
        gen = torch.Generator(device=cuda).manual_seed(7)
        fns.train_step(first, imgs[0], labels[0], mask, gen)
        ck.save_resume_checkpoint(tmp_path, 1, first, gen)
        resumed = _tiny_train_state(cuda)
        _, state = ck.restore_resume_checkpoint(tmp_path, 1, resumed)
        gen = torch.Generator(device=cuda)
        gen.set_state(state)
        fns.train_step(resumed, imgs[1], labels[1], mask, gen)
    assert resumed.step == ref.step == 2
    assert torch.equal(gen.get_state(), ref_gen)
    for name in ("mu", "nu", "ema_params", "ema_batch_stats"):
        for k, v in getattr(ref, name).items():
            assert torch.equal(getattr(resumed, name)[k], v), (name, k)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_homography_warp_on_the_card_matches_the_cpu(cuda):
    """The library warp at [8,224,224,3], one matrix an image (rotation,
    expand, shear, perspective), reflected and filled borders: card
    against CPU within 1e-3 on [0, 255] (the bar it keeps against JAX)."""
    from leaffliction_tpu_torch.ops import geometry as G

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 255, (8, 224, 224, 3)).astype(
        np.float32))
    mats = torch.stack([G.rotation_matrix(float(a), (224, 224))
                        for a in rng.uniform(-30, 30, 4)]
                       + [G.shear_matrix(0.15, True, (224, 224)),
                          G.shear_matrix(-0.2, False, (224, 224)),
                          G.solve_perspective_coeffs(
                              [(5, 3), (220, 9), (218, 221), (2, 215)],
                              [(0, 0), (224, 0), (224, 224), (0, 224)]),
                          torch.eye(3)])
    for fill in (None, 255.0):
        got = G.homography_warp(x.to(cuda), mats.to(cuda), (224, 224), fill)
        ref = G.homography_warp(x, mats, (224, 224), fill)
        assert (got.cpu() - ref).abs().max().item() <= 1e-3


def test_two_ranks_on_one_card_step_as_one_process(cuda, tmp_path):
    """Data parallelism on the card: two ranks share cuda:0 (gloo, since
    NCCL refuses two ranks on one GPU; worker processes of
    `tests/torch_dp_worker.py`), 3 leafcnn-tiny f32 steps at 32 px, 4
    images a rank, augmentation (K1) and dropout on, TF32 off and cuDNN
    deterministic, against one process at the global batch of 8 on the
    card: losses at rtol 1e-5 and the state after the first step at
    `tests/test_torch_train_step.py`'s first-step bars (params 1e-4,
    batch_stats 5e-6, moments 1e-4, EMA 1e-5 relative L2), the generators
    equal, both ranks' states bit-equal and K1 launched on each rank once a
    step."""
    import torch_dp_worker
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN, init_model
    from leaffliction_tpu_torch.train import steps
    from leaffliction_tpu_torch.train.config import TrainConfig

    k, widths, n_steps = 5, (16, 32, 64), 3
    model = init_model(LeafCNN(k, widths, drop_block=0.1, drop_top=0.3), 0)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (n_steps, 8, 32, 32, 3), np.uint8)
    labels = rng.integers(0, k, (n_steps, 8)).astype(np.int32)
    mask = np.ones((n_steps, 8), np.float32)
    mask[::2, -1] = 0.0
    np.savez(tmp_path / "steps.npz", images=images, labels=labels,
             mask=mask, **{f"sd.{n}": v.numpy()
                           for n, v in model.state_dict().items()})
    job = {"dir": str(tmp_path), "device": "cuda:0", "scenarios": [
        ("steps", {"kind": "steps", "classes": k, "widths": list(widths),
                   "config": "regularized", "total_steps": 20, "seed": 0,
                   "augment": True, "drop_block": 0.1, "drop_top": 0.3,
                   "inputs": str(tmp_path / "steps.npz")})]}
    a, b = torch_dp_worker.launch(job, world=2, timeout=300)["steps"]
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert int(a["k1_launches"]) == n_steps

    flags = torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                       benchmark=False, allow_tf32=False)
    with flags:
        state = steps.train_state_for(model.to(cuda))
        fns = steps.build_step_fns(TrainConfig.regularized(), k, 20)
        gen = torch.Generator(device=cuda).manual_seed(0)
        losses = []
        for i in range(n_steps):
            losses.append(float(fns.train_step(
                state, torch.from_numpy(images[i]).to(cuda),
                torch.from_numpy(labels[i]).long().to(cuda),
                torch.from_numpy(mask[i]).to(cuda), gen)["loss"]))
            if i == 0:
                first = {n: v.cpu().clone() for n, v in
                         torch_dp_worker._state_tensors(state).items()}
    np.testing.assert_allclose(a["metrics"][:, 0].numpy(), losses,
                               rtol=1e-5)
    assert torch.equal(a["generator"], gen.get_state())
    bars = {"model": 1e-4, "mu": 1e-4, "nu": 1e-4, "ema": 1e-5}
    for n, v in first.items():
        section = n.split(".", 1)[0]
        bar = (5e-6 if section == "model" and n.endswith((".mean", ".var"))
               else bars[section])
        got = a[f"step1.{n}"].double()
        err = float((got - v.double()).norm()
                    / v.double().norm().clamp_min(1e-30))
        assert err <= bar, (n, err)


def test_column_parallel_block_on_two_ranks_equals_one_process(cuda,
                                                               tmp_path):
    """Tensor parallelism on the card: a LeafCNN ResBlock 32 → 64 (its
    two convs, SE Conv_1, the shortcut and the BatchNorms sharded at
    min_size 64 over two ranks sharing cuda:0, gloo; worker processes of
    `tests/torch_dp_worker.py`), forward and backward in training mode,
    f32, TF32 off, cuDNN deterministic, against one process on the card:
    the gathered output at 1e-5, the full input's gradient (the model
    group's sum) and every parameter's gradient (gathered) within 1e-4
    relative L2, and both ranks alike."""
    import torch_dp_worker
    from leaffliction_tpu_torch.models.leafcnn import ResBlock, init_model

    block = init_model(ResBlock(32, 64, False, torch.float32), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32, 16, 16)).astype(np.float32)
    dy = rng.standard_normal((4, 64, 16, 16)).astype(np.float32)
    np.savez(tmp_path / "block.npz", x=x, dy=dy,
             **{f"sd.{n}": v.numpy() for n, v in block.state_dict().items()})
    job = {"dir": str(tmp_path), "device": "cuda:0", "mesh_data": 1,
           "mesh_model": 2, "scenarios": [
               ("block", {"kind": "block", "cin": 32, "features": 64,
                          "min_size": 64,
                          "inputs": str(tmp_path / "block.npz")})]}
    a, b = torch_dp_worker.launch(job, world=2, timeout=300)["block"]
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert int(a["n_sharded"]) > 0
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        block = block.to(cuda)
        xt = torch.from_numpy(x).to(cuda).requires_grad_(True)
        y = block(xt, train=True)
        params = [p for _, p in block.named_parameters()]
        grads = torch.autograd.grad(y, [xt] + params,
                                    torch.from_numpy(dy).to(cuda))
    assert (a["y"] - y.detach().cpu()).abs().max().item() <= 1e-5
    for name, want in [("dx", grads[0])] + [
            (f"grad.{n}", g) for (n, _), g in zip(block.named_parameters(),
                                                  grads[1:])]:
        want = want.detach().cpu().double()
        err = float((a[name].double() - want).norm()
                    / want.norm().clamp_min(1e-30))
        assert err <= 1e-4, (name, err)


def _chain_inputs(cuda, steps, n=24, b=8, size=64):
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                         dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 5, n)).to(cuda)
    sels = np.stack([rng.choice(n, b, replace=False)
                     for _ in range(steps)]).astype(np.int64)
    return data, labels, sels


def _same_states(a, b):
    from leaffliction_tpu_torch.train.graph import state_tensors

    ta, tb = state_tensors(a), state_tensors(b)
    return [i for i, (x, y) in enumerate(zip(ta, tb))
            if not torch.equal(x, y)]


@pytest.mark.parametrize("path", ["gather", "streamed"])
def test_step_graph_equals_eager_steps(cuda, path):
    """A K = 4 graph replayed twice, then the one-step graph once, against
    9 eager steps from the same state and generator (leafcnn-tiny with
    dropout, K1 and augmentation on, f32, cuDNN deterministic): every
    tensor of the state, the metrics and the generator state bit-equal,
    the step 9, and K1 counted once a step through the replays plus once
    for each graph's one-step warm-up (a capture launches nothing)."""
    from leaffliction_tpu_torch.data.loader import Batch
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.graph import StepGraphs
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    k, steps = 4, 9
    data, labels, sels = _chain_inputs(cuda, steps)
    fns = build_step_fns(TrainConfig.regularized(), 5, 100)

    def state():
        return create_train_state(LeafCNN(5, (16, 32, 64), drop_block=0.15,
                                          drop_top=0.3), 0, cuda)

    def host(lo, hi):
        sel = sels[lo:hi]
        return Batch(images=data.cpu().numpy()[sel],
                     labels=labels.cpu().numpy()[sel],
                     mask=np.ones(sel.shape, np.float32), indices=sel)

    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        ref, gen_e = state(), torch.Generator(device=cuda).manual_seed(3)
        mask = torch.ones(8, device=cuda)
        eager = [fns.train_step_gather(ref, data, labels,
                                       torch.from_numpy(sels[i]).to(cuda),
                                       mask, gen_e) for i in range(steps)]
        got, gen_g = state(), torch.Generator(device=cuda).manual_seed(3)
        graphs = StepGraphs(fns, got, gen_g)
        dd = (data, labels) if path == "gather" else None
        train_aug.launches = 0
        try:
            out = [graphs.train(host(0, 4), dd), graphs.train(host(4, 8), dd),
                   graphs.train(host(8, 9), dd)]
            torch.cuda.synchronize()
        finally:
            graphs.close()
    assert graphs.warmup_steps == 2
    assert train_aug.launches == steps + graphs.warmup_steps
    assert got.step == ref.step == steps
    assert _same_states(got, ref) == []
    assert torch.equal(gen_g.get_state(), gen_e.get_state())
    for name in ("loss", "correct", "n"):
        assert torch.equal(torch.cat([m[name] for m in out]),
                           torch.stack([m[name] for m in eager])), name
    assert list(np.concatenate([m["lr"] for m in out])) == \
        [m["lr"] for m in eager]


def test_chained_fit_on_the_card_equals_one_step_fit(cuda):
    """`fit(chain_steps=3)` (graphs: a chunk of 3 and the one-step graph
    for the remainder; the whole-val-set eval eager) against
    `fit(chain_steps=1)` (eager), on a device-resident set, cuDNN
    deterministic: the history, the state and the generator state
    bit-equal."""
    from leaffliction_tpu_torch.data.loader import (
        BatchIterator,
        DeviceImageStore,
    )
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )
    from leaffliction_tpu_torch.train.trainer import fit

    rng = np.random.default_rng(8)
    train = DeviceImageStore(rng.integers(0, 5, 30), 64)
    train.images = rng.integers(0, 256, (30, 64, 64, 3), dtype=np.uint8)
    train.host_pixels = True
    val = DeviceImageStore(rng.integers(0, 5, 10), 64)
    val.images = rng.integers(0, 256, (10, 64, 64, 3), dtype=np.uint8)
    val.host_pixels = True
    cfg = TrainConfig.regularized()
    runs = []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        for k in (1, 3):
            state = create_train_state(LeafCNN(5, (16, 32, 64),
                                               drop_block=0.15,
                                               drop_top=0.3), 0, cuda)
            runs.append(fit(build_step_fns(cfg, 5, 20), state,
                            BatchIterator(train, 8, shuffle=True, seed=2),
                            BatchIterator(val, 8, shuffle=False), cfg,
                            epochs=2, seed=5, device_dataset=True,
                            chain_steps=k))
    eager, chained = runs
    assert chained.history == eager.history
    assert chained.steps_ran == eager.steps_ran == 8
    assert _same_states(chained.state, eager.state) == []
    assert torch.equal(chained.generator_state, eager.generator_state)


def test_chained_fit_records_graph_spans(cuda, tmp_path):
    """A chained `fit` (K = 3 on 4 steps an epoch, 2 epochs) under the
    profiler: two `graphs.capture` spans (the K = 3 and K = 1 graphs), one
    `graphs.launch` a replay (`graphs.replays`, 4), each under its
    `trainer.dispatch`, a `graphs.stage` for each replay of a graph
    already captured, `graphs.capture_s` > 0, and every span its Chrome
    trace event within 1 ms."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from leaffliction_tpu_torch.core import trace
    from leaffliction_tpu_torch.data.loader import (
        BatchIterator,
        DeviceImageStore,
    )
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )
    from leaffliction_tpu_torch.train.trainer import fit

    rng = np.random.default_rng(8)
    train = DeviceImageStore(rng.integers(0, 5, 30), 64)
    train.images = rng.integers(0, 256, (30, 64, 64, 3), dtype=np.uint8)
    train.host_pixels = True
    val = DeviceImageStore(rng.integers(0, 5, 10), 64)
    val.images = rng.integers(0, 256, (10, 64, 64, 3), dtype=np.uint8)
    val.host_pixels = True
    cfg = TrainConfig.regularized()
    state = create_train_state(LeafCNN(5, (16, 32, 64)), 0, cuda)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(build_step_fns(cfg, 5, 20), state,
            BatchIterator(train, 8, shuffle=True, seed=2),
            BatchIterator(val, 8, shuffle=False), cfg, epochs=2, seed=5,
            log_every=0, device_dataset=True, chain_steps=3)
    got, counted = trace.spans(), trace.counters()
    trace.clear()
    names = [s.name for s in got]
    assert names.count("graphs.capture") == counted["graphs.captures"] == 2
    assert names.count("graphs.launch") == counted["graphs.replays"] == 4
    assert names.count("graphs.stage") == 2
    assert counted["graphs.capture_s"] > 0
    assert counted["trainer.dispatches"] == 4 and counted["trainer.steps"] == 8
    for s in got:
        if s.name.startswith("graphs."):
            assert got[s.parent].name == "trainer.dispatch", s
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())
    events = sorted((e for e in exported["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e.get("name") in set(names)), key=lambda e: e["ts"])
    assert len(events) == len(got)
    base = exported["baseTimeNanoseconds"]
    for s, e in zip(sorted(got, key=lambda s: s.start_ns), events):
        assert e["name"] == s.name
        assert abs(e["ts"] * 1e3 + base - s.start_ns) < 1e6
        assert abs(e["dur"] * 1e3 - (s.end_ns - s.start_ns)) < 1e6


def test_chain_dispatch_makes_no_host_sync(cuda):
    """After a warm-up, an eager dispatch of 2 steps (the code a graph
    captures, plus the table's one copy) under sync debug mode "error":
    no step reads the host."""
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import build_step_fns

    from leaffliction_tpu_torch.data.loader import Batch
    from leaffliction_tpu_torch.train.trainer import prefetch_to_device

    data, labels, sels = _chain_inputs(cuda, 2)
    fns = build_step_fns(TrainConfig.regularized(), 5, 100)
    state = _tiny_train_state(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    sel = torch.from_numpy(sels).to(cuda)
    mask = torch.ones(sel.shape, device=cuda)
    fns.train_step_gather(state, data, labels, sel, mask, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = fns.train_step_gather(state, data, labels, sel, mask, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 4 and np.isfinite(m["loss"].cpu().numpy()).all()
    # the streamed path: the chunk uploaded by prefetch_to_device (pinned
    # staging, side stream, event) and the dispatch on its tensors
    chunk = Batch(images=data.cpu().numpy()[sels],
                  labels=labels.cpu().numpy()[sels],
                  mask=np.ones(sels.shape, np.float32), indices=sels)
    for b in prefetch_to_device([chunk], cuda):  # warm-up
        fns.train_step_chain(state, b.images, b.labels, b.mask, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in prefetch_to_device([chunk, chunk], cuda):
            m = fns.train_step_chain(state, b.images, b.labels, b.mask, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 10 and np.isfinite(m["loss"].cpu().numpy()).all()


def test_prefetch_on_the_card_yields_the_host_batches(cuda):
    """`prefetch_to_device` on CUDA, 7 batches (chunks of 3 and single
    batches, so the staging slots change size) through a ring of 3: each
    device batch equals its host batch, the host `indices` are passed
    through, and the tensors live on the card."""
    from leaffliction_tpu_torch.data.loader import Batch
    from leaffliction_tpu_torch.train.trainer import (
        chain_batches,
        prefetch_to_device,
    )

    rng = np.random.default_rng(4)
    host = [Batch(images=rng.integers(0, 256, (8, 64, 64, 3), np.uint8),
                  labels=rng.integers(0, 5, 8).astype(np.int32),
                  mask=(rng.random(8) < 0.9).astype(np.float32),
                  indices=np.arange(8, dtype=np.int32) + 8 * i)
            for i in range(11)]
    want = list(chain_batches(iter(host), 3))
    got = list(prefetch_to_device(chain_batches(iter(host), 3), cuda, 2))
    torch.cuda.synchronize()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.images.device.type == "cuda"
        assert g.labels.dtype == torch.int64
        np.testing.assert_array_equal(g.images.cpu().numpy(), w.images)
        np.testing.assert_array_equal(g.labels.cpu().numpy(), w.labels)
        np.testing.assert_array_equal(g.mask.cpu().numpy(), w.mask)
        np.testing.assert_array_equal(g.indices, w.indices)


@pytest.mark.parametrize("k", [1, 4])
def test_streamed_fit_on_the_card_equals_gather(cuda, k):
    """`fit` on the streamed path (`prefetch_to_device`; K = 4: graphs
    copying the prefetched tensors into their inputs on the device) against
    the gather path from a device-resident set, cuDNN deterministic: the
    history, the state and the generator state bit-equal, and so are
    `evaluate`'s results on either path."""
    from leaffliction_tpu_torch.data.loader import (
        BatchIterator,
        DeviceImageStore,
    )
    from leaffliction_tpu_torch.models.leafcnn import LeafCNN
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )
    from leaffliction_tpu_torch.train.trainer import (
        evaluate,
        fit,
        put_dataset,
    )

    rng = np.random.default_rng(8)
    train = DeviceImageStore(rng.integers(0, 5, 40), 64)
    train.images = rng.integers(0, 256, (40, 64, 64, 3), dtype=np.uint8)
    train.host_pixels = True
    val = DeviceImageStore(rng.integers(0, 5, 10), 64)
    val.images = rng.integers(0, 256, (10, 64, 64, 3), dtype=np.uint8)
    val.host_pixels = True
    cfg = TrainConfig.regularized()
    runs, evals = [], []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        for device_dataset in (False, True):
            state = create_train_state(LeafCNN(5, (16, 32, 64),
                                               drop_block=0.15,
                                               drop_top=0.3), 0, cuda)
            fns = build_step_fns(cfg, 5, 20)
            val_iter = BatchIterator(val, 8, shuffle=False)
            runs.append(fit(fns, state,
                            BatchIterator(train, 8, shuffle=True, seed=2),
                            val_iter, cfg, epochs=2, seed=5,
                            device_dataset=device_dataset, chain_steps=k))
            evals.append(evaluate(fns, state, val_iter, device_data=(
                put_dataset(val, cuda) if device_dataset else None)))
    streamed, gather = runs
    assert streamed.history == gather.history
    assert streamed.steps_ran == gather.steps_ran == 10
    assert _same_states(streamed.state, gather.state) == []
    assert torch.equal(streamed.generator_state, gather.generator_state)
    assert evals[0][:2] == evals[1][:2]
    for a, b in zip(evals[0][2:], evals[1][2:]):
        np.testing.assert_array_equal(a, b)


# ---- BatchNorm (+ReLU): csrc/batch_norm.cu against the plain twin --------

# every distinct BatchNorm shape of the train cells (leafcnn-base b32, then
# resnet18 b128), a ragged row count and a width that is not a multiple of 8
BN_SHAPES = [(32, 32, 224, 224), (32, 64, 112, 112), (32, 128, 56, 56),
             (32, 256, 28, 28), (128, 64, 112, 112), (128, 64, 56, 56),
             (128, 128, 28, 28), (128, 256, 14, 14), (128, 512, 7, 7),
             (3, 64, 7, 5), (4, 12, 9, 9)]
BN_EPS, BN_MOMENTUM = 1e-5, 0.9


def _bn_inputs(cuda, shape, dtype, layout, seed=0):
    """x (≈ N(0.5, 2²)), dy (N(0, 1)) in `dtype` and `layout`; f32 scale,
    bias, running mean and var [C]."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, c, h, w = shape
    fmt = (torch.channels_last if layout == "cl"
           else torch.contiguous_format)

    def draw(scale, shift):
        t = torch.randn(shape, generator=g, device=cuda) * scale + shift
        return t.to(dtype).contiguous(memory_format=fmt)

    x, dy = draw(2.0, 0.5), draw(1.0, 0.0)
    params = [torch.rand(c, generator=g, device=cuda) * a + b
              for a, b in ((0.5, 0.75), (0.4, -0.2), (0.2, -0.1),
                           (1.0, 0.5))]
    return x, dy, params


def _sum_bound(terms, dims):
    """What f32 sums of `terms` in another order may differ by: 1e-5 of
    the sum of their magnitudes (2^-24 a term at worst, far less in a
    tree)."""
    return 1e-5 * terms.abs().sum(dim=dims) + 1e-6


def _bn_both(cuda, shape, dtype, relu, layout, seed=0):
    """The kernels (the module on the card: forward with the running
    update, backward) and the twin on the card, on the same inputs."""
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_train_plain

    x, dy, (scale, bias, rm, rv) = _bn_inputs(cuda, shape, dtype, layout,
                                              seed)
    bn = BatchNorm(shape[1], BN_EPS, dtype, BN_MOMENTUM).to(cuda)
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, rm),
                     (bn.var, rv)):
            t.copy_(v)
    xk = x.clone().requires_grad_()
    yk = bn(xk, train=True, relu=relu)
    yk.backward(dy)
    xt = x.clone().requires_grad_()
    st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    yt, mean, var = bn_train_plain(xt, st, bt, BN_EPS, relu=relu)
    yt.backward(dy)
    kernel = {"y": yk, "dx": xk.grad, "dg": bn.scale.grad,
              "db": bn.bias.grad, "mean": bn.mean, "var": bn.var}
    twin = {"y": yt, "dx": xt.grad, "dg": st.grad, "db": bt.grad,
            "mean": BN_MOMENTUM * rm + (1.0 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * rv + (1.0 - BN_MOMENTUM) * var}
    return x, dy, kernel, twin, (mean, var)


@pytest.mark.parametrize("layout", ["cl", "nchw"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernels_match_twin(cuda, shape, dtype, relu, layout):
    """Training BatchNorm on the kernels against the twin on the card, at
    every BatchNorm shape of the train cells. The batch statistics differ
    only by the f32 sums' order: the batch mean and var (read through the
    running update, m = 0.9) within 1e-5 relative; y within 1e-5 (f32) or
    one bf16 rounding step, 2^-7 relative (bf16), the twin's rsqrt being
    the card's approximate one; dγ, dβ within `_sum_bound` of their terms;
    dx within 1e-4 + 1e-5 relative (f32, the sums through Σ/M) or 2^-7
    (bf16), where both ReLU masks agree. The masks differ only where the
    normalised value is within rounding of 0: at most 1e-5 of the
    elements."""
    x, dy, k, t, (mean, var) = _bn_both(cuda, shape, dtype, relu, layout)
    for name in ("y", "dx"):
        assert k[name].dtype == dtype and k[name].stride() == x.stride()
    for name in ("mean", "var"):
        torch.testing.assert_close(k[name], t[name], rtol=1e-5, atol=1e-6)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(k["y"].float(), t["y"].float(), rtol=rtol,
                               atol=1e-5)
    dims = (0, 2, 3)
    kept = t["y"] > 0 if relu else torch.ones_like(x, dtype=torch.bool)
    dyk = torch.where(kept, dy.float(), 0.0)
    xhat = ((x.float() - mean.view(1, -1, 1, 1))
            * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1))
    assert ((k["db"] - t["db"]).abs() <= _sum_bound(dyk, dims)).all()
    assert ((k["dg"] - t["dg"]).abs() <= _sum_bound(dyk * xhat, dims)).all()
    agree = (k["y"] > 0) == kept if relu else kept
    assert (~agree).sum().item() <= 1e-5 * x.numel()
    torch.testing.assert_close(k["dx"].float()[agree],
                               t["dx"].float()[agree], rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("layout", ["cl", "nchw"])
@pytest.mark.parametrize("shape", [(32, 32, 224, 224), (128, 512, 7, 7),
                                   (3, 64, 7, 5), (4, 12, 9, 9)])
def test_bn_kernel_calls_are_bit_equal(cuda, shape, layout):
    """Two calls on the same inputs give the same bits: no atomics, the
    grid and every sum's order fixed by the shape."""
    runs = [_bn_both(cuda, shape, torch.bfloat16, True, layout)[2]
            for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


@pytest.mark.parametrize("layout", ["cl", "nchw"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype,out", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", [(32, 64, 112, 112), (128, 512, 7, 7),
                                   (3, 64, 7, 5), (4, 12, 9, 9)])
def test_bn_eval_kernel_matches_twin(cuda, shape, dtype, out, relu, layout):
    """Eval: the normalise kernel on the running statistics against the
    twin's eval arithmetic on the card, in the module's dtype `out`: the
    kernel's inv is 1/sqrt, the twin's the card's approximate rsqrt, so
    within 1e-6 relative in f32, one bf16 step in bf16."""
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_eval_plain

    x, _, (scale, bias, rm, rv) = _bn_inputs(cuda, shape, dtype, layout)
    bn = BatchNorm(shape[1], BN_EPS, out).to(cuda)
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, rm),
                     (bn.var, rv)):
            t.copy_(v)
        got = bn(x, relu=relu)
    want = bn_eval_plain(x, rm, rv, scale, bias, BN_EPS, out, relu)
    assert got.dtype == out and got.stride() == x.stride()
    rtol = 2.0 ** -7 if out == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        bn(x.requires_grad_(), relu=relu)


def test_bn_kernels_refuse_other_layouts_and_dtypes(cuda):
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm, bn_train

    bn = BatchNorm(16).to(cuda)
    base = torch.randn((2, 4, 16, 4), device=cuda)
    with pytest.raises(ValueError, match="neither"):
        bn(base.permute(0, 2, 1, 3), train=True)
    with pytest.raises(ValueError, match="neither"):
        with torch.no_grad():
            bn(torch.randn((2, 32, 4, 4), device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="no kernel"):
        bn_train(torch.randn((2, 16, 4, 4), device=cuda).half(), bn.scale,
                 bn.bias, 1e-3)


def test_bn_gradient_in_another_layout_is_copied(cuda):
    """A gradient that is not channels-last is copied into channels-last
    (counted) and gives the same dx as one that is."""
    from leaffliction_tpu_torch.ops.fused_bn import bn_train
    from leaffliction_tpu_torch.ops.kernels import batch_norm

    x, dy, (scale, bias, _, _) = _bn_inputs(cuda, (8, 64, 14, 14),
                                            torch.bfloat16, "cl")
    grads = []
    for d in (dy, dy.contiguous()):
        before = batch_norm.launches["copy"]
        xg = x.clone().requires_grad_()
        bn_train(xg, scale, bias, BN_EPS, relu=True)[0].backward(d)
        grads.append((xg.grad, batch_norm.launches["copy"] - before))
    assert grads[0][1] == 0 and grads[1][1] == 1
    assert torch.equal(grads[0][0], grads[1][0])


@pytest.mark.parametrize("train", [True, False])
def test_bn_channels_first_input_is_copied_in_and_out(cuda, train):
    """A channels-first x runs the same kernels on a channels-last copy:
    x copied in and y copied back (and, training, dy in and dx back),
    each counted; the results equal those of the channels-last x, in each
    input's layout."""
    from leaffliction_tpu_torch.ops.fused_bn import BatchNorm
    from leaffliction_tpu_torch.ops.kernels import batch_norm

    x, dy, _ = _bn_inputs(cuda, (8, 64, 14, 14), torch.bfloat16, "cl")
    got = []
    for layout in (torch.channels_last, torch.contiguous_format):
        bn = BatchNorm(64, BN_EPS, torch.bfloat16).to(cuda)
        xi = x.clone(memory_format=layout).requires_grad_(train)
        before = dict(batch_norm.launches)
        with torch.set_grad_enabled(train):
            y = bn(xi, train=train, relu=True)
            if train:
                y.backward(dy.contiguous(memory_format=layout))
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in batch_norm.launches.items()}
        assert y.stride() == xi.stride()
        if train:
            assert xi.grad.stride() == xi.stride()
        got.append((y, xi.grad, counts))
    (y_cl, dx_cl, n_cl), (y_cf, dx_cf, n_cf) = got
    assert n_cl["copy"] == 0 and n_cf["copy"] == (4 if train else 2)
    assert {k: v for k, v in n_cl.items() if k != "copy"} == \
        {k: v for k, v in n_cf.items() if k != "copy"}
    assert torch.equal(y_cl, y_cf)
    if train:
        assert torch.equal(dx_cl, dx_cf)


def _bn_kernel_events(prof):
    """Kernel events of the BatchNorm kernels by counter name."""
    names = {"stats": ("bn_reduce", "StatsOp"),
             "grad_reduce": ("bn_reduce", "GradOp"),
             "apply": ("bn_map", "ApplyOp"),
             "dx": ("bn_map", "DxOp"),
             "finalize": ("bn_finalize", "bn_finalize")}
    found = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        for counter, (kernel, op) in names.items():
            if kernel in e.key and op in e.key:
                found[counter] += e.count
    return found


def test_bn_launches_in_a_resnet18_graph_equal_profiled_kernels(cuda):
    """resnet18 at the train cell's shapes (224 px, b128, bf16,
    REGULARIZED) in a K = 4 graph: each of its 20 BatchNorms runs the four
    kernels in every step, with no tensor copied into or out of
    channels-last; the counters a replay adds equal the profiler's
    kernel events of that replay, and an eval's forward runs 20 normalise
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from leaffliction_tpu_torch.data.loader import Batch
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops.kernels import batch_norm
    from leaffliction_tpu_torch.train.config import TrainConfig
    from leaffliction_tpu_torch.train.graph import StepGraphs
    from leaffliction_tpu_torch.train.steps import (
        build_step_fns,
        create_train_state,
    )

    k, b, n = 4, 128, 160
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3),
                                         dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 8, n)).to(cuda)
    fns = build_step_fns(TrainConfig.regularized(), 8, 100)
    state = create_train_state(build_resnet(8, dtype=torch.bfloat16), 0,
                               cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    graphs = StepGraphs(fns, state, gen)

    def chunk():
        sel = np.stack([rng.choice(n, b, replace=False) for _ in range(k)])
        return Batch(images=None, labels=None,
                     mask=np.ones(sel.shape, np.float32), indices=sel)

    per_step = {"stats": 20, "apply": 20, "grad_reduce": 20, "dx": 20,
                "finalize": 40}
    try:
        before = dict(batch_norm.launches)
        # the one-step warm-up, the capture (counted back) and a replay
        graphs.train(chunk(), (data, labels))
        torch.cuda.synchronize()
        first = {key: batch_norm.launches[key] - before[key]
                 for key in before}
        assert first == {key: (1 + k) * per_step.get(key, 0)
                         for key in before}
        before = dict(batch_norm.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            graphs.train(chunk(), (data, labels))
            torch.cuda.synchronize()
    finally:
        graphs.close()
    counted = {key: batch_norm.launches[key] - before[key] for key in before}
    assert counted == {key: k * per_step.get(key, 0) for key in before}
    events = _bn_kernel_events(prof)
    assert events == {key: counted[key] for key in events}
    before = dict(batch_norm.launches)
    with torch.no_grad():
        state.model(data[:b].float() / 255.0)
    assert {key: batch_norm.launches[key] - before[key]
            for key in before} == {key: 20 if key == "apply" else 0
                                   for key in before}


# the residual blocks' exit (`csrc/block_exit.cu`): (shape, kind) at every
# exit of the train cells (leafcnn-base b32's four stages; resnet18 b128's
# stem pool and its blocks' four widths), and tiny odd shapes: one element
# a thread (c % 8 != 0), a floored 2x2 pool, SAME pads (1, 1) and (0, 1)
EXIT_CASES = {
    "leafcnn_base_0": ((32, 32, 224, 224), "leaf"),
    "leafcnn_base_1": ((32, 64, 112, 112), "leaf"),
    "leafcnn_base_2": ((32, 128, 56, 56), "leaf"),
    "leafcnn_base_3": ((32, 256, 28, 28), "leaf"),
    "resnet18_stem": ((128, 64, 112, 112), "stem"),
    "resnet18_64": ((128, 64, 56, 56), "block"),
    "resnet18_128": ((128, 128, 28, 28), "block"),
    "resnet18_256": ((128, 256, 14, 14), "block"),
    "resnet18_512": ((128, 512, 7, 7), "block"),
    "tiny_odd_leaf": ((3, 12, 7, 9), "leaf"),
    "tiny_odd_leaf_no_se": ((3, 16, 9, 5), "leaf_no_se"),
    "tiny_odd_stem": ((2, 12, 9, 8), "stem"),
    "tiny_even_stem": ((2, 16, 8, 8), "stem"),
    # pools no model runs: a 2x2/1 window walked at run time, and a SAME
    # 2x2/2 at odd sizes (padded bottom and right)
    "tiny_pool_2x2_s1": ((2, 16, 7, 6), "pool_2x2_s1"),
    "tiny_same_2x2": ((2, 16, 7, 9), "same_2x2"),
}


def _exit_parts(kind):
    """(se, shortcut, relu, drop, pool) of an exit kind."""
    from leaffliction_tpu_torch.ops.block_exit import Pool

    return {"leaf": (True, True, True, True, Pool(2, 2)),
            "leaf_no_se": (False, True, True, True, Pool(2, 2)),
            "block": (True, True, True, False, None),
            "stem": (False, False, False, False, Pool(3, 2, same=True)),
            "pool_2x2_s1": (True, True, True, True, Pool(2, 1)),
            "same_2x2": (True, True, True, False,
                         Pool(2, 2, same=True))}[kind]


def _exit_inputs(cuda, shape, kind, dtype, seed=0, ties=False):
    """y, se, shortcut, Drop (or None) and an output gradient on the card:
    y and the shortcut N(0, 1) (with `ties`, multiples of 1/4 in [-1, 1],
    so windows tie), se a sigmoid, the mask kept with probability 0.85; y
    and the shortcut channels-last."""
    from leaffliction_tpu_torch.ops.block_exit import Drop

    has_se, has_sc, relu, drop, pool = _exit_parts(kind)
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, c = shape[:2]

    def act():
        t = torch.randn(shape, generator=g, device=cuda)
        if ties:
            t = (t * 2).round().clamp(-4, 4) / 4
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    y, sc = act(), act() if has_sc else None
    se = torch.sigmoid(torch.randn((n, c, 1, 1), generator=g, device=cuda)
                       ).to(dtype) if has_se else None
    mask = Drop(torch.rand((n, c, 1, 1), generator=g, device=cuda) < 0.85,
                1.0 - 0.15) if drop else None
    return y, se, sc, relu, mask, pool


def _exit_grad(cuda, out, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(out.shape, generator=g, device=cuda).to(
        out.dtype).contiguous(memory_format=torch.channels_last)


def _twin_picks(pre, pool):
    """The twin's max-pool picks of `pre`, as flat indices h·W + w into
    pre's own plane (the twin's explicit SAME padding taken off)."""
    from leaffliction_tpu_torch.ops.layout import same_pads

    h, w = pre.shape[-2:]
    if not pool.same:
        return _pooled(pre, pool.k, pool.s, 0)[1]
    (top, bottom), (left, right) = same_pads(h, pool.k, pool.s), \
        same_pads(w, pool.k, pool.s)
    if top == bottom and left == right:
        return _pooled(pre, pool.k, pool.s, top)[1]
    padded = torch.nn.functional.pad(pre, (left, right, top, bottom),
                                     value=float("-inf"))
    idx = _pooled(padded, pool.k, pool.s, 0)[1]
    wide = w + left + right
    return (idx // wide - top) * w + (idx % wide - left)


def _pooled(x, k, s, pad):
    """max_pool2d's (output, picks)."""
    return torch.nn.functional.max_pool2d(x, k, s, padding=pad,
                                          return_indices=True)


def _kernel_picks(code, geo):
    """The kernel's codes as flat indices h·W + w into y's plane."""
    ky, kx = code.long() // geo.k, code.long() % geo.k
    oy = torch.arange(geo.oh, device=code.device).view(1, 1, -1, 1)
    ox = torch.arange(geo.ow, device=code.device).view(1, 1, 1, -1)
    return (oy * geo.s - geo.pad_h + ky) * geo.w + (ox * geo.s - geo.pad_w
                                                    + kx)


def _exit_both(cuda, shape, kind, dtype, ties=False, seed=0):
    """The kernels (through `block_exit`, forward and backward) and the
    twin on the card, on the same inputs and output gradient → (kernel,
    twin, inputs): out, dy, d_shortcut, d_se of each."""
    from leaffliction_tpu_torch.ops import block_exit as exits

    y, se, sc, relu, drop, pool = _exit_inputs(cuda, shape, kind, dtype,
                                               seed, ties)
    runs = []
    for fn in (exits.block_exit, exits.block_exit_plain):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in (y, se, sc)]
        out = fn(leaves[0], leaves[1], leaves[2], relu, drop, pool)
        want = [t for t in leaves if t is not None]
        grads = dict(zip([n for n, t in zip(("dy", "dse", "dsc"), leaves)
                          if t is not None],
                         torch.autograd.grad(out, want, _exit_grad(cuda,
                                                                   out))))
        runs.append({"out": out.detach(), **grads})
    return runs[0], runs[1], (y, se, sc, relu, drop, pool)


def _dse_bound(d_sc, y, dtype):
    """What the SE gate's gradient may differ by: the twin rounds each
    product d_shortcut·y to the dtype before the f32 sum and the sum to
    the dtype, the kernel only the sum (2^-8 of the terms' magnitudes and
    of the sum in bf16; f32 sums in another order, 1e-5 + 1e-6)."""
    terms = (d_sc.float() * y.float()).abs().sum(dim=(2, 3), keepdim=True)
    return (2.0 ** -8, 2.0 ** -8) if dtype == torch.bfloat16 else \
        (1e-5, 1e-6), terms


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(EXIT_CASES))
def test_block_exit_matches_twin(cuda, case, dtype):
    """The exit's kernels against the twin on the card: the output and the
    max-pool's picks bit-equal (ties and the −inf SAME padding included);
    dy and d_shortcut within one rounding step of the dtype (2^-7 relative
    in bf16, 1e-6 in f32: the kernel repeats the twin's arithmetic, so
    they read equal); d_se within `_dse_bound`."""
    from leaffliction_tpu_torch.ops import block_exit as exits
    from leaffliction_tpu_torch.ops.kernels import block_exit as kexit

    shape, kind = EXIT_CASES[case]
    k, t, (y, se, sc, relu, drop, pool) = _exit_both(
        cuda, shape, kind, dtype, ties=case.startswith("tiny"))
    assert k["out"].dtype == dtype
    assert k["out"].stride() == t["out"].contiguous(
        memory_format=torch.channels_last).stride()
    assert torch.equal(k["out"], t["out"])
    if pool is not None:
        _, code = kexit.forward(y, se, sc, relu, drop, pool, True)
        pre = exits.block_exit_plain(y, se, sc, relu, drop)
        geo = kexit.geometry(y, pool)
        assert torch.equal(_kernel_picks(code, geo), _twin_picks(pre, pool))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    for name in ("dy", "dsc"):
        if name in t:
            assert k[name].dtype == dtype
            torch.testing.assert_close(k[name], t[name], rtol=rtol, atol=0)
    if "dse" in t:
        (rel, absolute), terms = _dse_bound(t["dsc"], y, dtype)
        diff = (k["dse"].float() - t["dse"].float()).abs()
        assert (diff <= rel * (terms + t["dse"].float().abs())
                + absolute).all()


@pytest.mark.parametrize("case", ["leafcnn_base_1", "resnet18_stem",
                                  "resnet18_512", "tiny_odd_leaf"])
def test_block_exit_calls_are_bit_equal(cuda, case):
    """Two calls on the same inputs give the same bits, d_se included: no
    atomics, the grid and every sum's order fixed by the shape."""
    shape, kind = EXIT_CASES[case]
    runs = [_exit_both(cuda, shape, kind, torch.bfloat16)[0]
            for _ in range(2)]
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name


def test_block_exit_launches_and_layouts(cuda):
    """One forward and one backward launch an exit (and the finalisation
    with se), nothing copied on channels-last tensors; a channels-first y
    and shortcut run on channels-last copies, counted, with the same
    results in their own layout; an eval forward writes no codes."""
    from leaffliction_tpu_torch.ops import block_exit as exits
    from leaffliction_tpu_torch.ops.kernels import block_exit as kexit

    y, se, sc, relu, drop, pool = _exit_inputs(cuda, (4, 64, 14, 14),
                                               "leaf", torch.bfloat16)
    got = []
    for layout in (torch.channels_last, torch.contiguous_format):
        yi = y.clone(memory_format=layout).requires_grad_()
        sci = sc.clone(memory_format=layout).requires_grad_()
        sei = se.clone().requires_grad_()
        before = dict(kexit.launches)
        out = exits.block_exit(yi, sei, sci, relu, drop, pool)
        grads = torch.autograd.grad(out, (yi, sei, sci),
                                    _exit_grad(cuda, out).contiguous(
                                        memory_format=layout))
        counts = {key: v - before[key] for key, v in kexit.launches.items()}
        assert out.stride() == out.contiguous(memory_format=layout).stride()
        got.append((out, grads, counts))
    (o_cl, g_cl, n_cl), (o_cf, g_cf, n_cf) = got
    assert n_cl == {"forward": 1, "backward": 1, "finalize": 1, "copy": 0}
    assert n_cf["copy"] > 0 and {k: v for k, v in n_cf.items()
                                 if k != "copy"} == \
        {k: v for k, v in n_cl.items() if k != "copy"}
    assert torch.equal(o_cl, o_cf)
    for a, b in zip(g_cl, g_cf):
        assert torch.equal(a, b)
    before = dict(kexit.launches)
    with torch.no_grad():
        exits.block_exit(y, se, sc, relu, drop, pool)
    assert {key: v - before[key] for key, v in kexit.launches.items()} == \
        {"forward": 1, "backward": 0, "finalize": 0, "copy": 0}


def test_block_exit_refuses_what_it_does_not_take(cuda):
    from leaffliction_tpu_torch.ops import block_exit as exits

    x = torch.randn((2, 16, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        exits.block_exit(x.half(), shortcut=x.half())
    with pytest.raises(ValueError, match="neither"):
        exits.block_exit(x.permute(0, 2, 1, 3), shortcut=x)
    with pytest.raises(ValueError, match="no kernel"):
        exits.block_exit(x, relu=False, pool=exits.Pool(17, 1))


@pytest.mark.parametrize("arch,sites", [("leafcnn-base", (4, 4)),
                                        ("resnet18", (9, 8))])
def test_block_exit_launches_in_a_model_step(cuda, arch, sites):
    """A bf16 training forward and backward of each train cell's model at
    224 px runs one forward and one backward launch an exit (leafcnn-base:
    4 stages; resnet18: 8 blocks and the stem's pool), one finalisation an
    exit with SE, nothing copied; an eval forward one forward launch an
    exit."""
    from leaffliction_tpu_torch.models.leafcnn import build_leafcnn, init_model
    from leaffliction_tpu_torch.models.resnet import build_resnet
    from leaffliction_tpu_torch.ops.kernels import block_exit as kexit

    exits_n, with_se = sites
    model = init_model(build_leafcnn(8, "base", dtype=torch.bfloat16)
                       if arch == "leafcnn-base"
                       else build_resnet(8, dtype=torch.bfloat16), 0).to(cuda)
    x = torch.rand((2, 224, 224, 3), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = dict(kexit.launches)
    model(x, train=True, generator=gen).float().sum().backward()
    assert {k: v - before[k] for k, v in kexit.launches.items()} == {
        "forward": exits_n, "backward": exits_n, "finalize": with_se,
        "copy": 0}
    before = dict(kexit.launches)
    with torch.no_grad():
        model(x)
    assert {k: v - before[k] for k, v in kexit.launches.items()} == {
        "forward": exits_n, "backward": 0, "finalize": 0, "copy": 0}


@pytest.mark.parametrize("shape", [(32, 256, 14, 14), (128, 512, 7, 7)])
def test_global_mean_is_the_nchw_mean_on_the_card(cuda, shape):
    """The models' GAP over the channels-last view gives the NCHW mean's
    bits on the card too (bf16 in, f32 out), forward and gradient, and a
    channels-last gradient."""
    from leaffliction_tpu_torch.models.leafcnn import global_mean

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last
                                   ).requires_grad_()
    dx = torch.randn(shape[:2], generator=g, device=cuda)
    got, want = global_mean(x), x.float().mean(dim=(2, 3))
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad(got, x, dx)
    g_want, = torch.autograd.grad(want, x, dx)
    assert torch.equal(g_got, g_want)
    assert g_got.is_contiguous(memory_format=torch.channels_last)
