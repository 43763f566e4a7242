"""Launchers: the train and serve drivers (the JAX package's
``launch/train.py`` and ``launch/serve.py``), on one device."""
