"""One driver per traffic kind, found by the kind's name (``cells.traffic``)."""
