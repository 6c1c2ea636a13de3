"""The offline data prep (``cli prep``): stages, fusions, adapters and the
pipeline that writes the ``prepared_data/`` artifacts."""
