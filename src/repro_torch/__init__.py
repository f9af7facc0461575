"""``repro_torch`` — the PyTorch and CUDA port of ``repro``.

The package mirrors the reference's module paths (``repro_torch.blocks``
is the counterpart of ``repro.blocks``, and so on) and serves the same
plan artifacts.  It imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``repro``: the JAX package stays the
reference that the tests hold this one against.

The slices ported so far: the synchronous CNN serving path (plan JSON
→ ``runtime.CompiledCNN`` → per layer ``ConvBlock.apply_batched_requant``
on the CUDA kernels ``conv1_layer``, ``fused_dot_layer`` and
``packed_dot_layer``, the last two through their requantizing entries →
``serve.CNNEngine``); the per-plane block path
and the planner (``conv2_planes``, ``conv3_planes``, ``conv4_planes``);
and LM serving for the dense and SSM families (``models`` →
``serve.Engine``, on ``flash_attention`` and ``causal_conv1d``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
