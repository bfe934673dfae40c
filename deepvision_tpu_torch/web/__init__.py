"""The interview app on the port's engines: the JAX app's web layer
(``deepvision_tpu/web/``) with its model gateway built by
:func:`deepvision_tpu_torch.web.gateway.build_gateway`.  Run:
``python -m deepvision_tpu_torch.web.server``."""
