"""PyTorch/CUDA port of the scene-text recognizer for NVIDIA Hopper.

The JAX package ``multimodal_scene_text_recognition_tpu`` is the reference;
this package imports nothing of it.  Entry points: :func:`api.get_model` and
:class:`eval.serve.Recognizer`.
"""
