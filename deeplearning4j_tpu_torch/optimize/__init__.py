"""Training-loop helpers of the port (mirrors ``deeplearning4j_tpu/optimize``)."""
