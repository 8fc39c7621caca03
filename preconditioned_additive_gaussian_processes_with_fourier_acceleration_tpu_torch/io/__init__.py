from .readers import read_features, read_labels, read_windows
