"""One driver per kind of cell; a traffic mix names its driver."""
