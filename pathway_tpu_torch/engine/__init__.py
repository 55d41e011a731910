"""Engine package: values, streams, nodes, expression evaluation."""
