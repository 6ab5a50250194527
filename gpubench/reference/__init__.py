"""The yardstick's own inputs and answers: frozen graph generators and the
plain per-vertex triangle count and LCC. Imports numpy and torch only."""
