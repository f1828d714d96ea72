"""The decoder language model (dense family so far): config, layers,
attention and parameter initialisation."""
