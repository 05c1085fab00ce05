"""Model substrate: config, layers, attention, transformer, facade."""
