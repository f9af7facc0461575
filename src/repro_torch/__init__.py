"""``repro_torch`` — the PyTorch and CUDA port of ``repro``.

The package mirrors the reference's module paths (``repro_torch.blocks``
is the counterpart of ``repro.blocks``, and so on) and serves the same
plan artifacts.  It imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``repro``: the JAX package stays the
reference that the tests hold this one against.

The slice ported so far is the synchronous CNN serving path: plan JSON →
``runtime.CompiledCNN`` → per layer ``ConvBlock.apply_batched`` (three
hand-written CUDA kernels: ``conv1_layer``, ``fused_dot_layer``,
``packed_dot_layer``) → ``core.cnn._requantize`` → ``serve.CNNEngine``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
