"""ikea_recommender_tpu_torch — the PyTorch/CUDA port of ikea_recommender_tpu.

The port runs on an NVIDIA H100. It keeps the reference package's module
names, so each counterpart is easy to find, and it imports nothing of that
package (nor JAX): where it needs a numpy-only module it keeps its own copy.

So far it serves: ``run.serve.Recommender`` scores padded session batches
top-k for all five families, and ``run.recommend`` is the batch-inference
CLI. It trains gru4rec, bidir_gru4rec, sqn and smorl (``train``), and
``eval.protocol.EvalProtocol`` scores an eval buffer into the reference's
metrics. The GRU recurrence is a hand-written CUDA kernel
(``csrc/gru_fwd.cu``, wrapped by ``ops.gru_cuda``). Entry points run on
the card unless the caller passes ``device="cpu"``; the CPU runs each
kernel's plain PyTorch twin.

- ``core``    — experiment config schema, device choice.
- ``data``    — tokenizer, eval windows and buffers, unpopular items.
- ``ops``     — the CUDA kernels' wrappers and their build, blockwise head
  top-k, ranking, coverage, rewards.
- ``eval``    — the evaluation protocol.
- ``train``   — train state, Adam and the train steps.
- ``utils``   — metric-name logging dicts.
- ``models``  — embedding + GRU backbone + heads, all five families.
- ``run``     — params npz, serving, batch-inference CLI.
- ``convert`` — reference-layout numpy params -> the port's tensors.
"""

__version__ = "0.1.0"
