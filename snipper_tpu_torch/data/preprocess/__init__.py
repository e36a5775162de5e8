"""Offline dataset preprocessing (reference ``datasets/data_preprocess/``):
one module per source, each regenerating the same pickle/JSON files the
reference's scripts emit, cv2/pycocotools-free. The port's own copy of
``snipper_tpu/data/preprocess``: the same raw input gives the same files."""
