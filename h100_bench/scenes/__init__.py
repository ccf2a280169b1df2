"""Scene recipes, one module a configuration (`scenes/<recipe>.py`)."""
