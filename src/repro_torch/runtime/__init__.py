from .driver import DriverConfig, TrainDriver, SimulatedFailure
