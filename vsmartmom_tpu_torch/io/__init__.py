"""Scene-file front end (counterpart of the JAX package's ``io/``): the
YAML / TOML / JSON loaders and schema check (``formats``), the parser into
``Parameters`` (``yaml_input``) and the GEOS-Chem column reader
(``geoschem``)."""
