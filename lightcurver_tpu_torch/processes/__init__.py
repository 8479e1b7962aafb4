"""The numerical bodies of the pipeline tasks."""
