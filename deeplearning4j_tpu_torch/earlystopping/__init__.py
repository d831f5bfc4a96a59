from .earlystopping import (AccuracyScoreCalculator, BestScoreEpochTerminationCondition,
                            DataSetLossCalculator, EarlyStoppingConfiguration,
                            EarlyStoppingResult, EarlyStoppingTrainer, InMemoryModelSaver,
                            InvalidScoreIterationTerminationCondition, LocalFileModelSaver,
                            MaxEpochsTerminationCondition, MaxScoreIterationTerminationCondition,
                            MaxTimeIterationTerminationCondition,
                            ScoreImprovementEpochTerminationCondition)

__all__ = ["AccuracyScoreCalculator", "BestScoreEpochTerminationCondition",
           "DataSetLossCalculator", "EarlyStoppingConfiguration", "EarlyStoppingResult",
           "EarlyStoppingTrainer", "InMemoryModelSaver",
           "InvalidScoreIterationTerminationCondition", "LocalFileModelSaver",
           "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
           "MaxTimeIterationTerminationCondition", "ScoreImprovementEpochTerminationCondition"]
