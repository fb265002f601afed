"""The plain reference: DeepLabV3+ (a backbone found by name under
``backbones/``, the ASPP middle, boundary refinement), its preprocessing,
loss and Keras-semantics Adam, in plain float32 PyTorch.  Written from the
published model's equations and the Keras reference's conventions; it
imports nothing of the program under test.
"""
