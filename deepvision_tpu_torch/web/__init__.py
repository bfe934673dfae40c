"""The app's side of the port: the model gateway built from the app's
settings (:func:`deepvision_tpu_torch.web.gateway.build_gateway`)."""
