"""Model spec, synthetic parameter trees and the Llama forward."""
