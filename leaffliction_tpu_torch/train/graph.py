"""CUDA graphs of `fit`'s train dispatches on the card: K steps a replay.

JAX compiles `train_step_chain` (a `lax.scan` of K steps) once and reruns
the program; `jit` is its capture, so this module has no counterpart
there. `StepGraphs` captures `StepFns.chain` (K steps: the augmentation
with kernel K1, forward, backward, the optimizer and the EMA) into a CUDA
graph at its first use and replays it:

- static inputs: the [K, 3] hyper table and the mask, with `sel` on the
  device-resident path or the pixels and labels on the streamed one; each
  dispatch copies into them: the table and the gather path's host arrays
  from the host, the streamed path's pixels, labels and mask from the
  device tensors `trainer.prefetch_to_device` uploaded (device to
  device);
- before each capture, a warm-up of the dispatch's first step on a side
  stream: cuBLAS and cuDNN set up for its shapes, K1's library loaded and
  its cluster query cached, the BatchNorm kernels' block counts cached
  (the other K − 1 steps have the same shapes). It leaves no trace in
  the run: the params, BatchNorm statistics, moments and EMA are copied
  back and the generator's state is set back. Its launches ran on the
  card and stay counted (`warmup_steps`);
- the training generator is registered with each train graph
  (`CUDAGraph.register_generator_state`), so a replay draws at the Philox
  offsets K eager steps would draw at and advances the generator as they
  do: a checkpoint's generator state after a replay is the eager one;
- one graph per (K, path), kept until `close`, which `fit` calls when it
  ends;
- spans `graphs.stage` (the copies into the static inputs),
  `graphs.launch` (a replay) and `graphs.capture` (a warm-up and its
  capture), and counters `graphs.replays`, `graphs.captures` and
  `graphs.capture_s` (`core/trace.py`);
- the kernels' wrappers count a call where it runs (the counters
  registered with `kernels/build.py`: K1's, the BatchNorm kernels' and
  every other kernel's), and a call made while capturing only records the
  launch: the capture's counts are taken back, and each replay adds the
  launches its graph holds (`launches`), which the profiler's kernel
  events of a chained run confirm (`chip_smoke.py` phase 27 for K1,
  `tests/test_torch_gpu.py` for the BatchNorm kernels).

The whole-set eval stays eager (`StepFns.eval_chain_gather`, one host
read an eval): it is device-bound, so on an H100 a graph of it saved 4–6%
of an eval and repaid its capture only after 26–59 evals
(`tools/time_chain.py`).

A capture that fails raises; nothing falls back to eager steps. The graphs
hold the state's tensors by address, so whatever changes them between
replays does so in place (`trainer._restore`, the checkpoint restore before
`fit`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from leaffliction_tpu_torch.core import trace
from leaffliction_tpu_torch.kernels import build
from leaffliction_tpu_torch.train.steps import StepFns, TrainState

DeviceData = Tuple[torch.Tensor, torch.Tensor]


@contextlib.contextmanager
def recorded() -> Iterator[Dict[str, int]]:
    """Around a capture: yields a dict that holds, after the block, the
    launches each registered kernel counter (`build.launch_counts`)
    counted inside it, and takes them back from the counters (a capture
    records launches, it runs none)."""
    before = build.launch_counts()
    launches: Dict[str, int] = {}
    try:
        yield launches
    finally:
        launches.update({name: n - before.get(name, 0)
                         for name, n in build.launch_counts().items()
                         if n != before.get(name, 0)})
        build.add_launches({name: -n for name, n in launches.items()})


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step writes: the model's params and buffers,
    Adam's moments and the EMA."""
    return [t.detach() for t in (
        *state.model.parameters(), *state.model.buffers(),
        *(v for d in (state.mu, state.nu, state.ema_params,
                      state.ema_batch_stats) for v in d.values()))]


class _Captured:
    """A captured dispatch: its graph, static inputs (by name) and outputs,
    and the launches each replay makes, by counter name."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 inputs: Dict[str, torch.Tensor], outputs,
                 launches: Dict[str, int]):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


Dispatch = Callable[[Dict[str, torch.Tensor]], object]


class StepGraphs:
    """The CUDA graphs of one `fit` on one card (see the module
    docstring)."""

    def __init__(self, step_fns: StepFns, state: TrainState,
                 generator: torch.Generator) -> None:
        self.step_fns, self.state, self.generator = step_fns, state, generator
        self.device = generator.device
        self._train: Dict[Tuple[int, bool], _Captured] = {}
        self.warmup_steps = 0  # train steps the warm-ups ran (K1 each)

    def train(self, chunk, data: Optional[DeviceData]) -> Dict[str, object]:
        """One dispatch of a chunk [K, B, ...]: the rows `chunk.indices`
        (host) of the device-resident `data` with the host mask, or, with
        `data` None, the chunk's pixels, labels and mask as device tensors
        (`trainer.prefetch_to_device`) → loss, correct, n stacked [K]
        (device) and lr [K] (host), as `StepFns.train_step_chain`."""
        k = len(chunk.mask)
        hyper = self.step_fns.hyper_table(self.state, k)
        fields = {"hyper": (hyper, np.float32),
                  "mask": (chunk.mask, np.float32)}
        if data is not None:
            fields["sel"] = (chunk.indices, np.int64)
        else:
            fields["images"] = (chunk.images, np.uint8)
            fields["labels"] = (chunk.labels, np.int64)
        arrays = {n: a if isinstance(a, torch.Tensor)
                  else torch.from_numpy(np.asarray(a, dtype))
                  for n, (a, dtype) in fields.items()}
        cap = self._train.get((k, data is not None))
        if cap is None:
            def dispatch(inputs):
                return self.step_fns.chain(
                    self.state, inputs["hyper"], inputs["mask"],
                    self.generator, images=inputs.get("images"),
                    labels=inputs.get("labels"), data=data,
                    sel=inputs.get("sel"))

            with trace.span("graphs.capture"):
                cap = self._capture(dispatch, {
                    n: a.to(self.device, copy=True)
                    for n, a in arrays.items()})
            self._train[(k, data is not None)] = cap
        else:
            with trace.span("graphs.stage"):
                for name, a in arrays.items():
                    cap.inputs[name].copy_(a, non_blocking=True)
        out = self._replay(cap).clone()
        self.state.step += k
        return {"loss": out[:, 0], "correct": out[:, 1], "n": out[:, 2],
                "lr": hyper[:, 0]}

    def _capture(self, dispatch: Dispatch, inputs: Dict[str, torch.Tensor]
                 ) -> _Captured:
        """Warm up `dispatch` on the first row of each input (one step) on a
        side stream, put back what it changed, and capture it over the
        whole `inputs` with the generator registered."""
        t0 = time.perf_counter()
        gen = self.generator
        live = state_tensors(self.state)
        saved = [t.clone() for t in live]
        gen_state = gen.get_state()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            dispatch({n: t[:1] for n, t in inputs.items()})
        current.wait_stream(side)
        with torch.no_grad():
            torch._foreach_copy_(live, saved)
        del saved
        gen.set_state(gen_state)
        self.warmup_steps += 1
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        # thread-local: the step checkpointer's thread may copy to the host
        # while this thread captures
        with recorded() as launches, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            outputs = dispatch(inputs)
        trace.count("graphs.captures")
        trace.count("graphs.capture_s", time.perf_counter() - t0)
        return _Captured(graph, inputs, outputs, launches)

    def _replay(self, cap: _Captured):
        with trace.span("graphs.launch"):
            cap.graph.replay()
        trace.count("graphs.replays")
        build.add_launches(cap.launches)
        return cap.outputs

    def close(self) -> None:
        """Release every graph and its memory pool (after the card has run
        the last replay)."""
        if self._train:
            torch.cuda.synchronize(self.device)
        for cap in self._train.values():
            cap.graph.reset()
        self._train.clear()
