"""The frozen plain reference of the ACR demo chain.

Plain PyTorch and NumPy (with cv2 for the host image resizes the
demo's own pipeline uses), written from the ACR paper and the reference
implementation's description: the HRNet-W32 network and the ACR heads
(``network``), centre decoding and parameter sampling (``parse``),
rotations and MANO (``mano``), the OneEuro filter (``temporal``), the
camera (``camera``), the mesh render and the composite (``render``,
``host``). It imports nothing of ``jax``, ``acr_tpu`` or
``acr_tpu_torch``. The program's outputs are read only to be judged.
"""
