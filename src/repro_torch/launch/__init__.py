"""Launchers: the train and serve drivers (the JAX package's
``launch/train.py`` and ``launch/serve.py``) and ``mesh``: process groups
(``init_ranks``) and device meshes (``make_mesh``) over
``torch.distributed`` ranks.  The train driver runs on one device or over
a mesh's data ranks."""
