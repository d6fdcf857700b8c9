"""ikea_recommender_tpu_torch — the PyTorch/CUDA port of ikea_recommender_tpu.

The port runs on an NVIDIA H100. It keeps the reference package's module
names, so each counterpart is easy to find, and it imports nothing of that
package (nor JAX): where it needs a numpy-only module it keeps its own copy.
Each subpackage exports the reference's names, imported at first use.

It does what the reference package does: ``run.serve.Recommender`` and
the batch CLI ``run.recommend`` serve all five families; ``run.trainer``
and its CLI ``run.cli`` train gru4rec, bidir_gru4rec, sqn, smorl and sarm
(the fast preset, bf16 compute, and on a ``(data, model)`` mesh of one
process per rank), evaluated by ``eval.protocol.EvalProtocol``;
``run.retailrocket`` is the RetailRocket protocol without pandas, and
``parallel.scaling_bench`` times a step over meshes. The six Pallas
kernels of the reference are hand-written CUDA C++ (``csrc/``, wrapped by
``ops.gru_cuda``, ``ops.fused_ce`` and ``ops.fused_argmax``). Entry points
run on the card unless the caller passes ``device="cpu"``; the CPU runs
each kernel's plain PyTorch twin.

- ``core``     — experiment config schema, device choice, the mesh.
- ``data``     — tokenizer, windowing, buffers, data preparation.
- ``models``   — embedding + GRU backbone + heads, all five families.
- ``ops``      — the CUDA kernels' wrappers and their build, blockwise head
  top-k, ranking, coverage, rewards, RL ops.
- ``train``    — train states, Adam, lazy Adam and the train steps.
- ``eval``     — the evaluation protocol.
- ``parallel`` — the mesh's sharded ops and rules, the scaling bench.
- ``run``      — the trainer, checkpoints, serving, the CLIs, RetailRocket.
- ``analysis`` — embedding neighbours, trajectories, prediction reports.
- ``utils``    — metric-name logging dicts, invocation records.
- ``convert``  — reference-layout numpy params -> the port's tensors.
"""

__version__ = "0.1.0"
