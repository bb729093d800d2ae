"""fill.train (%): readers.fill, in both training cells."""

import readers

read = readers.fill
