"""Device and mesh layer of the PyTorch port: the one-device surface
(``device.py``), the row mesh over a process group (``mesh.py``) and its
map/reduce (``map_reduce.py``)."""
