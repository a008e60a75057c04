"""Train / serve step builders (``steps``) and the train driver (``train``)."""
